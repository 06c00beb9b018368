"""Whole runs on the CPU at a tiny size (the port's plain versions): the
result line's keys, no device metric, a workload found by its file alone,
and ``correct`` false under each fault that a cell can have."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness, manifest
from conftest import REPO

CELLS = tuple(w["name"] for w in manifest.load(REPO)["workloads"])  # a new cell is rehearsed
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(root, cell, seed=2**31 + 5):
    return harness.run(cell, seed, 0.5, False, root, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_contract_keys(tiny_root, cell, capsys):
    result = run(tiny_root, cell)
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["metrics"] == {}  # no device metric off the card
    assert line["device"]["platform"] == "cpu"
    assert [x.split()[1] for x in err.strip().splitlines()[-len(line["checks"]):]] == list(
        line["checks"])  # the numbers compared end standard error
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())


def test_a_new_workload_file_is_found(tiny_root):
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    entry = dict(manifest["workloads"][0], name="infer.fp32.small", traffic="small")
    manifest["workloads"].append(entry)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copy(tiny_root / "benchmark/workloads/infer.fp32.grid.json",
                tiny_root / "benchmark/workloads/infer.fp32.small.json")
    assert run(tiny_root, "infer.fp32.small")["correct"] is True


def test_answer_altered_where_produced(tiny_root, monkeypatch):
    from phyloformer_tpu_torch.infer.engine import InferenceEngine

    predict = InferenceEngine.predict

    def altered(self, alns):
        out = predict(self, alns)
        out[0] = out[0].copy()
        out[0][0] += 0.05
        return out

    monkeypatch.setattr(InferenceEngine, "predict", altered)
    for cell in ("infer.fp32.grid", "serve.tf32.poisson"):
        assert run(tiny_root, cell)["correct"] is False


def test_step_returns_its_state_unchanged(tiny_root, monkeypatch):
    from phyloformer_tpu_torch.train.trainer import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self, grads: False)
    result = run(tiny_root, "train.tf32.recipe")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    from phyloformer_tpu_torch.train import trainer

    make = trainer.make_train_step

    def halving(*args, **kwargs):
        step = make(*args, **kwargs)

        def halved(state, batch, *rest):
            batch = dict(batch)
            mask = batch["seq_mask"].copy()
            mask[len(mask) - len(mask) // 2:] = False
            batch["seq_mask"] = mask
            return step(state, batch, *rest)

        return halved

    monkeypatch.setattr(trainer, "make_train_step", halving)
    assert run(tiny_root, "train.tf32.recipe")["correct"] is False


def test_fault_only_after_the_checked_steps(tiny_root, monkeypatch):
    """A step that goes wrong only after set-up's steps (here: half of each
    batch left out from the window on) is caught by the window's last step."""
    from phyloformer_tpu_torch.train import trainer

    make = trainer.make_train_step

    def late_fault(*args, **kwargs):
        step, calls = make(*args, **kwargs), [0]

        def stepped(state, batch, *rest):
            calls[0] += 1
            if calls[0] > 8:
                batch = dict(batch)
                mask = batch["seq_mask"].copy()
                mask[len(mask) - len(mask) // 2:] = False
                batch["seq_mask"] = mask
            return step(state, batch, *rest)

        return stepped

    monkeypatch.setattr(trainer, "make_train_step", late_fault)
    result = run(tiny_root, "train.tf32.recipe")
    over = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert result["correct"] is False and "late_loss_gap" in over
    assert not over & {"loss_gap", "grad_gap", "change_gap"}  # set-up's steps were sound


def test_command_without_a_card_gives_no_result(tmp_path):
    """No card here: exit non-zero, and nothing on standard output."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "7", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "7", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_run(card, cell):
    """On the card: a short run of each cell is correct."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "123456789", "--seconds", "3", "--trace", "0"], capture_output=True,
                         text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_training_control_fails(tiny_root):
    """The reference at bf16, put in the program's place, against the fp32
    reference on the cell's checked batches: over a limit."""
    import torch

    from benchmark import compare, traffic

    cell = harness.load_cell("train.tf32.recipe", tiny_root)
    mod = harness.load_runner(cell.bench, "train")
    corpus = traffic.pool(cell.workload["corpus"], 77)
    ids = [[0, 1], [2, 3], [4, 5]]
    ref = mod.follow(cell, corpus, ids, torch.device("cpu"), torch.float32)
    low = mod.follow(cell, corpus, ids, torch.device("cpu"), torch.bfloat16)
    gaps = compare.train_gaps(low, ref)
    assert any(gaps[k] > v for k, v in cell.workload["limits"].items())
    assert compare.train_gaps(ref, ref) == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
