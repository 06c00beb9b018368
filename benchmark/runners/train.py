"""The fine-tuning step of the round-5 recipe (``pf-train-torch
--packed-data --loss mre --batch-size 8 --max-batch-tokens 2000000
--learning-rate 1e-4 --warmup-steps 800 --max-steps 10000``) on the fused
route: the port's ``PackedBucketedLoader`` (its loading thread running)
feeds ``make_train_step``'s step, which runs the forward and backward
kernels and Adam.

Set-up builds one train state from the workload's checkpoint and drives it
through its first steps: the first ``checked_steps`` are the ones the
reference follows from the checkpoint (their losses, the first gradient as
Adam's first moment holds it after one step, and the parameters' change
after them); then one step for each batch shape of the first epoch that
those did not take, which warms every shape the window meets.  The window
runs the same state on, whole epoch after whole epoch, until it has run
its seconds.  Before each of its steps it copies the parameters and Adam's
moments aside (one ``_foreach_copy_``), so that its last step is checked
too: the reference takes that copy, the program's own state, and makes the
step again on the same batch (its loss and each leaf's change).

Workload keys: ``weights``, ``corpus`` (a mix of
:func:`benchmark.traffic.pool`; the targets are the trees' patristic
distances), ``train`` (the recipe's numbers), ``checked_steps``,
``limits``.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, traffic
from benchmark.reference import phyloformer as reference
from benchmark.rooflines import model

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MRE_EPS = 1e-8

# The port's parameter tree's names → the reference checkpoint's.
_ATTN = {"wq": "q_proj.weight", "bq": "q_proj.bias", "wk": "k_proj.weight",
         "bk": "k_proj.bias", "wv": "v_proj.weight", "bv": "v_proj.bias",
         "wo": "out_proj.weight", "bo": "out_proj.bias"}
_FFN = {"w1": "ffn.0.weight", "b1": "ffn.0.bias", "w2": "ffn.3.weight", "b2": "ffn.3.bias"}


def reference_name(path: List) -> str:
    """A leaf's path in the port's tree → its name in the reference's."""
    if path[0] == "embed":
        return "embedding_block.0." + {"w": "weight", "b": "bias"}[path[1]]
    if path[0] == "head":
        return "pwFNN.0." + {"w": "weight", "b": "bias"}[path[1]]
    block, group, leaf = path[1], path[2], path[3]
    pre = f"attention_blocks.{block}."
    if group.endswith("_norm"):
        return pre + group + "." + {"scale": "weight", "bias": "bias"}[leaf]
    if group == "ffn":
        return pre + _FFN[leaf]
    return pre + {"row_attn": "row_attention.", "col_attn": "col_attention."}[group] + _ATTN[leaf]


def named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (i,))
    else:
        yield reference_name(list(path)), tree


class _Examples:
    """The in-memory corpus as the packed loader reads it."""

    def __init__(self, corpus, alignment_cls):
        self.corpus, self.cls = corpus, alignment_cls

    def __len__(self):
        return len(self.corpus)

    def __getitem__(self, i):
        it = self.corpus[i]
        return (self.cls(codes=it["codes"], ids=[f"s{k}" for k in range(it["n"])]),
                it["dists"].astype(np.float32))


def corpus_keys(corpus) -> Dict:
    """Each example's ``(n, l, codes)`` key → its index in the corpus."""
    return {(it["n"], it["l"], it["codes"].tobytes()): k for k, it in enumerate(corpus)}


def batch_ids(batch, keys: Dict) -> List[int]:
    """The corpus indices of a batch's real rows."""
    out = []
    for row in range(batch["codes"].shape[0]):
        n, l = int(batch["seq_mask"][row].sum()), int(batch["site_mask"][row].sum())
        if n:
            codes = np.ascontiguousarray(batch["codes"][row, :n, :l]).astype(np.int8)
            out.append(keys[(n, l, codes.tobytes())])
    return out


def to_reference_layout(leaf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A leaf of the port's tree (matrices ``(in, out)``) in the layout of
    the reference's parameter ``like`` (``(out, in)``, 1x1 convolutions
    ``(out, in, 1, 1)``)."""
    leaf = leaf.detach().float()
    return (leaf.t() if leaf.ndim == 2 else leaf).reshape(like.shape)


def lr_factor(step: int, warmup: int, total: int) -> float:
    """The recipe's linear warmup then linear decay, at an update's index."""
    warm = step / max(1.0, float(warmup))
    decay = (float(total) - step) / max(1.0, float(total - warmup))
    return min(max(min(warm, decay), 0.0), 1.0)


class Runner:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device

    def setup(self) -> None:
        from phyloformer_tpu_torch.data.fasta import Alignment
        from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
        from phyloformer_tpu_torch.train.data import LoaderConfig
        from phyloformer_tpu_torch.train.packed import PackedBucketedLoader
        from phyloformer_tpu_torch.train.trainer import (
            TrainConfig, create_train_state, make_train_step)

        wl, tr = self.cell.workload, self.cell.workload["train"]
        self.corpus = traffic.pool(wl["corpus"], self.seed)
        keys = corpus_keys(self.corpus)
        self.loader = PackedBucketedLoader(
            _Examples(self.corpus, Alignment),
            LoaderConfig(batch_size=tr["batch_size"], max_batch_tokens=tr["max_batch_tokens"],
                         seed=self.seed))
        params, cfg, _ = load_pretrained(self.cell.path(wl["weights"]))
        cfg = dataclasses.replace(cfg, matmul_precision=self.cell.config["matmul_precision"])
        tcfg = TrainConfig(loss=tr["loss"], learning_rate=tr["learning_rate"],
                           warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                           use_pallas=True)
        self.state, self.tx = create_train_state(cfg, tcfg, params=params, device=self.device)
        self.step = make_train_step(cfg, tcfg, self.tx)

        start = {n: t.detach().clone() for n, t in named_leaves(self.state["params"])}
        epoch = iter(self.loader)
        self.checked_ids, self.checked_shapes, losses = [], [], []
        for k in range(int(wl["checked_steps"])):
            batch = next(epoch)
            self.checked_ids.append(batch_ids(batch, keys))
            self.checked_shapes.append(tuple(batch["codes"].shape))
            self.state, logs = self.step(self.state, batch)
            losses.append(logs["train_loss"])
            if k == 0:
                grad = {n: self._first_moment(t) / (1.0 - BETAS[0])
                        for n, t in named_leaves(self.state["params"])}
        self.prog = {"losses": [float(x) for x in losses], "grad": grad,
                     "change": {n: float((t.detach() - start[n]).norm())
                                for n, t in named_leaves(self.state["params"])}}
        self.steps = len(losses)
        seen = set(self.checked_shapes)
        for batch in epoch:  # one batch of each shape of the epoch not yet taken
            if tuple(batch["codes"].shape) not in seen:
                seen.add(tuple(batch["codes"].shape))
                self.state, logs = self.step(self.state, batch)
                self.steps += 1
        float(logs["train_loss"])
        self.keys = keys
        # the parameters and Adam's moments, in one order, and a copy of each
        # (a step that never updates leaves no moments: they read as zeros)
        names, leaves = zip(*named_leaves(self.state["params"]))
        moments = [self.tx.opt.state.get(t, {}).get(k, torch.zeros_like(t.detach()))
                   for k in ("exp_avg", "exp_avg_sq") for t in leaves]
        self.names, self.live = list(names), [t.detach() for t in leaves] + moments
        self.kept = [torch.empty_like(t) for t in self.live]

    def _first_moment(self, leaf) -> float:
        st = self.tx.opt.state.get(leaf, {})
        return float(st["exp_avg"].norm()) if "exp_avg" in st else float("nan")

    def counters(self):
        return {}

    def window(self, win, seconds: float):
        """Whole epochs until the window has run its seconds: every epoch
        is the same work in another order, so a window's rate does not
        depend on where in an epoch it was cut."""
        wait, losses, sizes, last = 0.0, [], [], None
        while win.elapsed() < seconds:
            epoch = iter(self.loader)
            while True:
                t = time.perf_counter()
                batch = next(epoch, None)
                wait += time.perf_counter() - t
                if batch is None:
                    break
                torch._foreach_copy_(self.kept, self.live)
                self.state, logs = self.step(self.state, batch)
                losses.append(logs["train_loss"])
                last = batch
                for row in range(batch["codes"].shape[0]):
                    n = int(batch["seq_mask"][row].sum())
                    if n:
                        sizes.append((n, int(batch["site_mask"][row].sum())))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = win.elapsed()
        self.losses, self.last = losses, last
        self.steps += len(losses)
        items = [{"n": n, "l": l} for n, l in sizes]
        return {
            "end_to_end": {"examples_per_s": len(sizes) / elapsed},
            "spans": {"loader.wait_s": wait},
            "model_flop": sum(model.train_flop(n, l, self.cell.config) for n, l in sizes),
            "pair_sites": traffic.real_pair_sites(items),
            "units": len(losses),
        }

    def settle(self):
        """Steps whose loss is not finite have failed.  The window's last
        step is kept for the check: its batch, its loss, the state copied
        before it and the parameters after it, on the host."""
        finite = torch.isfinite(torch.stack(self.losses)).cpu().numpy()
        n = len(self.names)
        self.late = {
            "ids": batch_ids(self.last, self.keys), "step": self.steps - 1,
            "loss": float(self.losses[-1]),
            "before": {k: dict(zip(self.names, (t.cpu() for t in self.kept[i * n:(i + 1) * n])))
                       for i, k in enumerate(("params", "exp_avg", "exp_avg_sq"))},
            "after": {name: t.detach().cpu() for name, t in zip(self.names, self.live)},
        }
        return {"attempted": len(self.losses), "failed": int((~finite).sum())}

    def release(self) -> None:
        self.state = self.tx = self.step = self.loader = None
        self.live = self.kept = None
        gc.collect()

    def check(self) -> Dict[str, float]:
        ref = follow(self.cell, self.corpus, self.checked_ids, self.device, torch.float32)
        late = follow_late(self.cell, self.corpus, self.late, self.device, torch.float32)
        self.notes = compare.worst_leaves(self.prog, ref)
        return {**compare.train_gaps(self.prog, ref),
                **compare.late_gaps(late_reading(self.late), late)}


def late_reading(late: Dict) -> Dict:
    """The program's readings of the window's last step: its loss and each
    leaf's change."""
    before = late["before"]["params"]
    return {"loss": late["loss"],
            "change": {n: float((t - before[n]).norm()) for n, t in late["after"].items()}}


def follow(cell, corpus, batches_ids, device, dtype, keep=None) -> Dict:
    """The reference's readings over the checked steps: plain autograd on
    each example alone (batch 1, exact sizes), the recipe's masked-mean MRE
    over the step's real pairs, and a plain Adam with the recipe's
    schedule.  ``dtype``: float32 (the reference) or bfloat16 (the
    control).  ``keep(ids)``: which of a step's examples to use (a fault
    that drops part of the batch); all by default."""
    tr = cell.workload["train"]
    net = reference.from_checkpoint(cell.path(cell.workload["weights"]), cell.config, device,
                                    dtype)
    params = dict(net.named_parameters())
    start = {n: p.detach().float().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    losses, grad = [], None
    with reference.fp32_products():
        for t, ids in enumerate(batches_ids, start=1):
            ids = keep(ids) if keep is not None else ids
            count = sum(corpus[i]["n"] * (corpus[i]["n"] - 1) // 2 for i in ids)
            total = 0.0
            for p in params.values():
                p.grad = None
            for i in ids:
                x = reference.one_hot(torch.as_tensor(corpus[i]["codes"]), dtype).to(device)
                target = torch.as_tensor(corpus[i]["dists"], dtype=torch.float32, device=device)
                pred = net(x)[0].float()
                loss = ((pred - target).abs() / (target + MRE_EPS)).sum() / count
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            g = {n: p.grad.float() for n, p in params.items()}
            if grad is None:
                grad = {n: float(x.norm()) for n, x in g.items()}
            lr = tr["learning_rate"] * lr_factor(t - 1, tr["warmup_steps"], tr["total_steps"])
            with torch.no_grad():
                for n, p in params.items():
                    m[n].mul_(BETAS[0]).add_(g[n], alpha=1 - BETAS[0])
                    v[n].mul_(BETAS[1]).addcmul_(g[n], g[n], value=1 - BETAS[1])
                    m_hat = m[n] / (1 - BETAS[0] ** t)
                    v_hat = v[n] / (1 - BETAS[1] ** t)
                    p.sub_((lr * m_hat / (v_hat.sqrt() + ADAM_EPS)).to(p.dtype))
    change = {n: float((p.detach().float() - start[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "grad": grad, "change": change}


def follow_late(cell, corpus, late: Dict, device, dtype, keep=None) -> Dict:
    """The reference's readings of one step from the program's state before
    the window's last step (``late["before"]``, the only thing it takes of
    the program's): the loss on that step's batch and the change a plain
    Adam makes at that step's place in the schedule, each leaf's change and
    gradient by name.  ``dtype`` and ``keep``: as for :func:`follow`."""
    tr = cell.workload["train"]
    net = reference.from_checkpoint(cell.path(cell.workload["weights"]), cell.config, device,
                                    dtype)
    params = dict(net.named_parameters())
    state = {k: {n: to_reference_layout(t, params[n]).to(device)
                 for n, t in late["before"][k].items()}
             for k in ("params", "exp_avg", "exp_avg_sq")}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n].to(p.dtype))
    ids = keep(late["ids"]) if keep is not None else late["ids"]
    count = sum(corpus[i]["n"] * (corpus[i]["n"] - 1) // 2 for i in ids)
    total = 0.0
    with reference.fp32_products():
        for i in ids:
            x = reference.one_hot(torch.as_tensor(corpus[i]["codes"]), dtype).to(device)
            target = torch.as_tensor(corpus[i]["dists"], dtype=torch.float32, device=device)
            loss = ((net(x)[0].float() - target).abs() / (target + MRE_EPS)).sum() / count
            loss.backward()
            total += float(loss.detach())
    t = int(late["step"]) + 1
    lr = tr["learning_rate"] * lr_factor(t - 1, tr["warmup_steps"], tr["total_steps"])
    change, grad = {}, {}
    for n, p in params.items():
        g = p.grad.float()
        m = BETAS[0] * state["exp_avg"][n] + (1 - BETAS[0]) * g
        v = BETAS[1] * state["exp_avg_sq"][n] + (1 - BETAS[1]) * g * g
        step = lr * (m / (1 - BETAS[0] ** t)) / ((v / (1 - BETAS[1] ** t)).sqrt() + ADAM_EPS)
        start = state["params"][n].to(p.dtype)
        change[n] = float(((start - step.to(p.dtype)).float() - start.float()).norm())
        grad[n] = float(g.norm())
    return {"loss": total, "change": change, "grad": grad}
