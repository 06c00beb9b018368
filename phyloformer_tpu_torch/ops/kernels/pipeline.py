"""Pipelined fused forward: one kernel per block boundary.

The PyTorch side of the CUDA kernels in ``csrc/axial_pipeline.cu`` and the
counterpart of ``phyloformer_tpu/ops/pallas/pipeline.py``:

- :func:`kernel_p0`: pair gather ``emb[i] + emb[j]`` + block-0 kernel A
  (row attention, then the column stats of its output);
- :func:`kernel_a_only`: kernel A on a pair tensor gathered outside, x1
  written in place;
- :func:`kernel_m` (× n_blocks − 1): kernel B of block i, then kernel A of
  block i+1, x1 in place;
- :func:`kernel_z`: the last kernel B, the softplus head and the masked site
  mean;
- :func:`reduce_stats`: the per-block column-stat partials summed in a fixed
  order (:func:`reduce_slots`, the slot reduction it shares with the
  backward's partials; its plan and ordered twin are in ``reduce.py``).

The kernels take the JAX pipeline's static variants: the TF32 passes of
every product (``passes``: 3, split TF32, at ``mxu_precision="highest"``;
1, one TF32 pass, otherwise), the storage type of x1 between the kernels
(fp32 or bf16: P0 takes it as ``act_dtype``, A-only, M and Z read it from
their x1) and, in M and Z, the FFN's activation (:data:`.axial_block.GELU_MODES`,
each at both storage types).  At bf16 the stored x1 is rounded
to nearest even and the column stats are taken from the rounded values.

Each wrapper takes its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel and adds one to its entry in :data:`LAUNCHES`, or raises.  The plain
versions (``*_plain``) run on any device; ``chip_smoke.py`` uses them as the
kernels' references on the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import torch

from ...data.pairs import pair_indices
from . import _build
from . import axial_block
from .axial_block import (
    GELU_MODES,
    PASSES,
    body_b,
    body_col_stats,
    body_row_attn,
    expand_qk_weights,
    head,
    passes_of,
    tf32_rna,
)
from .reduce import reduce_plan

# Block 0 gathers pairs inside the kernel when one batch element's (n, L, d)
# fp32 embedding is at most this size and the pair count at most 8192 (the
# JAX pipeline's rule); otherwise the pair tensor is gathered outside and
# kernel A-only runs on it.
P0_EMB_BUDGET_BYTES = 4 * 1024 * 1024
P0_MAX_PAIRS = 8192

D_KERNEL = 64  # the only width the CUDA kernels are built for
TILE_SITES = 16  # sites per tile of kernel E1's stream (TS in axial_pipeline.cuh)
FWD_TILE_SITES = 64  # sites per tile of the forward kernels (FT there)
# Packed weight sizes (floats) of the kernels' groups; see axial_pipeline.cuh.
ROW_SIZE = 2 * D_KERNEL + 4 * (D_KERNEL * D_KERNEL + D_KERNEL)
COL_SIZE = 2 * D_KERNEL + 3 * (D_KERNEL * D_KERNEL + D_KERNEL)
B_SIZE = (4 * D_KERNEL + 2 * (D_KERNEL * D_KERNEL + D_KERNEL)
          + 2 * 4 * D_KERNEL * D_KERNEL + 4 * D_KERNEL + D_KERNEL)
HEAD_SIZE = D_KERNEL + 1
# The same groups' matrices in the mma layout (pack_mma): two floats each.
ROW_MMA_SIZE = 2 * 4 * D_KERNEL * D_KERNEL
COL_MMA_SIZE = 2 * 3 * D_KERNEL * D_KERNEL
B_MMA_SIZE = 2 * (2 * D_KERNEL * D_KERNEL + 2 * 4 * D_KERNEL * D_KERNEL)
# Kernel M's weight planes (pack_wg): 64 x 64 blocks of the groups'
# matrices, two TF32 images each, in the order M's products read them.
WG_PLANE = 2 * D_KERNEL * D_KERNEL
ROW_WG_SIZE = 4 * WG_PLANE  # wq, wk, wv, wo
COL_WG_SIZE = 3 * WG_PLANE  # wq, wk, wv
B_WG_SIZE = 10 * WG_PLANE  # cwq, cwo, w1's four column blocks, w2's four row blocks
M_CONSUMERS = 2  # kernel M's consumer warpgroups a block, each with its own slots
LAYOUT = (ROW_SIZE, COL_SIZE, B_SIZE, HEAD_SIZE, ROW_MMA_SIZE, COL_MMA_SIZE, B_MMA_SIZE,
          TILE_SITES, FWD_TILE_SITES, ROW_WG_SIZE, COL_WG_SIZE, B_WG_SIZE, M_CONSUMERS)
# Storage of x1 between the pipeline's kernels, by JAX's name, and the
# kernels' codes for it (STORE_F32, STORE_BF16 in axial_pipeline.cuh).
ACT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel in this process (the CPU path counts nothing);
# kernel_a, kernel_b, kernel_a1 and kernel_a2 are the fused forward's
# (ops/kernels/fused.py), kernel_c, kernel_d, kernel_e, kernel_e1, kernel_e2
# and reduce_partials the fused backward's (ops/kernels/axial_block_bwd.py).
#
# kernel_m counts kernel M at fp32 storage (warpgroup MMA), kernel_m_bf16 at
# bf16 storage (the mma.sync bodies): a run shows which design ran.
LAUNCHES: Dict[str, int] = {
    "kernel_p0": 0, "kernel_a_only": 0, "kernel_m": 0, "kernel_m_bf16": 0, "kernel_z": 0,
    "reduce_stats": 0,
    "kernel_a": 0, "kernel_b": 0, "kernel_a1": 0, "kernel_a2": 0,
    "kernel_c": 0, "kernel_d": 0, "kernel_e": 0, "kernel_e1": 0, "kernel_e2": 0,
    "reduce_partials": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_layout_checked = False


def _lib() -> ctypes.CDLL:
    """The kernel library, its packed weight layout and tile sizes checked
    on first use."""
    global _layout_checked
    lib = _build.load()
    if not _layout_checked:
        sizes = (ctypes.c_int * len(LAYOUT))()
        lib.pf_weight_sizes(ctypes.addressof(sizes))
        if tuple(sizes) != LAYOUT:
            raise RuntimeError(f"packed weight layout mismatch: library {tuple(sizes)}, "
                               f"wrapper {LAYOUT}")
        _layout_checked = True
    return lib


def pack_mma(w: torch.Tensor) -> torch.Tensor:
    """A ``(K, N)`` fp32 matrix → ``2 K N`` floats in the order the forward
    kernels' ``mma.m16n8k8`` TF32 B fragments are read, split for three
    passes: for k-step ``j``, n-tile ``n`` and lane ``4 g + t``, the float4
    ``(big b0, big b1, small b0, small b1)`` with ``b0 = W[8j + t, 8n + g]``,
    ``b1 = W[8j + t + 4, 8n + g]``, ``big = tf32_rna(W)`` and
    ``small = tf32_rna(W - big)``."""
    K, N = w.shape
    big = tf32_rna(w)
    small = tf32_rna(w - big)
    # (s, j, h, t, n, g) with k = 8j + 4h + t, column 8n + g
    split = torch.stack([big, small]).view(2, K // 8, 2, 4, N // 8, 8)
    return split.permute(1, 4, 5, 3, 0, 2).reshape(-1)


def unpack_mma(packed: torch.Tensor, K: int, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`pack_mma`'s reordering: ``(big, small)``, each
    ``(K, N)``."""
    split = packed.view(K // 8, N // 8, 8, 4, 2, 2).permute(4, 0, 5, 3, 1, 2)
    split = split.reshape(2, K, N)
    return split[0], split[1]


def _k_slots() -> torch.Tensor:
    """Logical k of each physical k of a w2 plane: kernel M takes the GELU
    chunk as wgmma's A operand from its accumulator, whose columns
    ``8j + 2t + e`` land on the A fragment's k slot ``8j + t + 4e``."""
    s = torch.arange(D_KERNEL)
    return 8 * (s // 8) + 2 * (s % 4) + (s % 8) // 4


def pack_wg(w: torch.Tensor, permute_k: bool = False) -> torch.Tensor:
    """A ``(64, 64)`` fp32 block ``W[k, n]`` → ``WG_PLANE`` floats: the
    shared-memory image of kernel M's warpgroup MMA B operand (K-major, no
    swizzle), big TF32 image then small, element ``(n, k)`` at float
    ``(k // 4) 256 + (n // 8) 32 + (n % 8) 4 + k % 4`` of each.  With
    ``permute_k`` physical row ``k`` holds logical row ``_k_slots()[k]``."""
    if permute_k:
        w = w[_k_slots()]
    big = tf32_rna(w)
    small = tf32_rna(w - big)
    # (s, kc, kr, n8, nr) with k = 4 kc + kr, n = 8 n8 + nr
    split = torch.stack([big, small]).view(2, D_KERNEL // 4, 4, D_KERNEL // 8, 8)
    return split.permute(0, 1, 3, 4, 2).reshape(-1)


def unpack_wg(plane: torch.Tensor, permute_k: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`pack_wg`: ``(big, small)``, each ``(64, 64)``
    in logical row order."""
    split = plane.view(2, D_KERNEL // 4, D_KERNEL // 8, 8, 4).permute(0, 1, 4, 2, 3)
    split = split.reshape(2, D_KERNEL, D_KERNEL)
    if permute_k:
        out = torch.empty_like(split)
        out[:, _k_slots()] = split
        split = out
    return split[0], split[1]


def _wg_planes(parts: Sequence[torch.Tensor],
               planes: Sequence[Tuple[int, int, int, bool]]) -> torch.Tensor:
    """``planes``: (index in parts, first row, first column, permute_k) of
    each 64 x 64 block, in kernel M's order."""
    d = D_KERNEL
    return torch.cat([pack_wg(parts[i][k0:k0 + d, n0:n0 + d], perm)
                      for i, k0, n0, perm in planes])


@dataclass(frozen=True)
class WeightGroup:
    """One kernel's weight group: the tensors in the kernel's order (for the
    plain versions), the same values packed into one buffer (for CUDA) and,
    for the forward kernels' groups, the matrices among them in the mma
    layout (:func:`pack_mma`, concatenated in order; empty otherwise) and
    kernel M's planes of them (:func:`pack_wg`; empty otherwise)."""

    parts: Tuple[torch.Tensor, ...]
    flat: torch.Tensor
    mma: torch.Tensor
    wg: torch.Tensor

    @classmethod
    def of(cls, parts: Sequence[torch.Tensor], mats: Sequence[int] = ()) -> "WeightGroup":
        """``mats``: the indices in ``parts`` of the matrices to pack for the
        tensor cores."""
        parts = tuple(p.contiguous() for p in parts)
        flat = torch.cat([p.reshape(-1) for p in parts]).contiguous()
        mma = (torch.cat([pack_mma(parts[i]) for i in mats]) if mats
               else flat.new_empty((0,)))
        return cls(parts, flat, mma, flat.new_empty((0,)))


def row_group(layer) -> WeightGroup:
    la = layer["row_attn"]
    return WeightGroup.of((layer["row_norm"]["scale"], layer["row_norm"]["bias"],
                           la["wq"], la["bq"], la["wk"], la["bk"], la["wv"], la["bv"],
                           la["wo"], la["bo"]), mats=(2, 4, 6, 8))


def col_group(layer) -> WeightGroup:
    ca = layer["col_attn"]
    return WeightGroup.of((layer["col_norm"]["scale"], layer["col_norm"]["bias"],
                           ca["wq"], ca["bq"], ca["wk"], ca["bk"], ca["wv"], ca["bv"]),
                          mats=(2, 4, 6))


def b_group(layer) -> WeightGroup:
    ca, ffn = layer["col_attn"], layer["ffn"]
    return WeightGroup.of((layer["col_norm"]["scale"], layer["col_norm"]["bias"],
                           ca["wq"], ca["bq"], ca["wo"], ca["bo"],
                           layer["ffn_norm"]["scale"], layer["ffn_norm"]["bias"],
                           ffn["w1"], ffn["b1"], ffn["w2"], ffn["b2"]), mats=(2, 4, 8, 10))


# Kernel M's planes of each group's matrices (:func:`_wg_planes`), in the
# order its products read them: the pipeline's weights carry them
# (PipelineWeights), the fused forward's groups do without.
ROW_PLANES = ((2, 0, 0, False), (4, 0, 0, False), (6, 0, 0, False), (8, 0, 0, False))
COL_PLANES = ((2, 0, 0, False), (4, 0, 0, False), (6, 0, 0, False))
B_PLANES = (((2, 0, 0, False), (4, 0, 0, False))
            + tuple((8, 0, D_KERNEL * c, False) for c in range(4))
            + tuple((10, D_KERNEL * c, 0, True) for c in range(4)))


def _with_planes(g: WeightGroup, planes) -> WeightGroup:
    """``g`` with kernel M's planes; kernel M is built for d = 64 alone, so
    other widths (which run the plain versions) keep none."""
    if g.parts[planes[0][0]].shape != (D_KERNEL, D_KERNEL):
        return g
    return replace(g, wg=_wg_planes(g.parts, planes))


@dataclass(frozen=True)
class PipelineWeights:
    """A model's parameters arranged for the pipeline (q/k pre-expanded),
    held as fp32.  ``param_dtype`` is the type the parameters came in:
    bf16 parameters (JAX's ``precision="bfloat16"``) are held as their exact
    fp32 values, and the embedding is then computed at bf16, as JAX computes
    it from bf16 weights, and widened to fp32 for block 0."""

    embed_w: torch.Tensor
    embed_b: torch.Tensor
    row: List[WeightGroup]
    col: List[WeightGroup]
    b: List[WeightGroup]
    head: WeightGroup
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def from_params(cls, params) -> "PipelineWeights":
        """``params``: a tree of fp32 tensors, or of bf16 tensors."""
        from ...models.params import map_params  # models imports this module

        param_dtype = params["embed"]["w"].dtype
        if param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"parameters of type {param_dtype}: expected fp32 or bf16")
        params = map_params(lambda t: t.to(torch.float32), params)
        layers = [expand_qk_weights(ly) for ly in params["layers"]]
        return cls(
            embed_w=params["embed"]["w"], embed_b=params["embed"]["b"],
            row=[_with_planes(row_group(ly), ROW_PLANES) for ly in layers],
            col=[_with_planes(col_group(ly), COL_PLANES) for ly in layers],
            b=[_with_planes(b_group(ly), B_PLANES) for ly in layers],
            head=WeightGroup.of((params["head"]["w"], params["head"]["b"])),
            param_dtype=param_dtype)


# ---- plain versions -------------------------------------------------------
# x1 comes back in its storage type (the input's for A-only and M, act_dtype
# for P0); every body computes in fp32.

def _kernel_a_plain(x, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes,
                    act_dtype):
    """Row attention, x1 stored as act_dtype, then the column stats of the
    stored x1."""
    x1 = body_row_attn(x, smask, rw.parts, eps, passes).to(act_dtype)
    return x1, body_col_stats(x1.float(), pmask, cw.parts, eps, passes)


def kernel_p0_plain(emb, ii, jj, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps,
                    passes=3, act_dtype=torch.float32):
    x = emb.index_select(1, ii.long()) + emb.index_select(1, jj.long())
    return _kernel_a_plain(x, smask, pmask, rw, cw, eps, passes, act_dtype)


def kernel_a_only_plain(x, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes=3):
    return _kernel_a_plain(x.float(), smask, pmask, rw, cw, eps, passes, x.dtype)


def kernel_m_plain(x1, stats, smask, pmask, pair_count, bw: WeightGroup, rw: WeightGroup,
                   cw: WeightGroup, eps, gelu_mode="exact", passes=3):
    x3 = body_b(x1.float(), stats, pair_count.clamp_min(1.0), bw.parts, eps, gelu_mode, passes)
    return _kernel_a_plain(x3, smask, pmask, rw, cw, eps, passes, x1.dtype)


def kernel_z_plain(x1, stats, smask, pair_count, bw: WeightGroup, hw: WeightGroup, eps,
                   gelu_mode="exact", passes=3):
    x3 = body_b(x1.float(), stats, pair_count.clamp_min(1.0), bw.parts, eps, gelu_mode, passes)
    return head(x3, hw.parts[0], hw.parts[1], smask)


def reduce_stats_plain(partial):
    return partial.sum(dim=1)


# ---- CUDA wrappers --------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _require(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """``dtype``: the one dtype, or a collection of those allowed."""
    allowed = dtype if isinstance(dtype, (tuple, list, dict)) else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {' or '.join(map(str, allowed))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _require_groups(**groups: Tuple[WeightGroup, int, int]) -> None:
    """Each group's flat buffer and its mma-layout matrices: sizes, and the
    16-byte alignment of the fragment loads."""
    for name, (g, size, mma_size) in groups.items():
        _require(g.flat, name, (size,))
        _require(g.mma, f"{name} (mma layout)", (mma_size,))
        if g.mma.data_ptr() % 16:
            raise ValueError(f"{name} (mma layout): not 16-byte aligned")


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The forward kernels fit two blocks an SM (~104 KB of shared memory each);
# their grids are four such waves.
RESIDENT_BLOCKS = 2
WAVES = 4


def _grid_blocks(B: int, device: torch.device) -> int:
    """Blocks per batch element that give about RESIDENT_BLOCKS x WAVES (8)
    per SM over the grid."""
    return math.ceil(RESIDENT_BLOCKS * WAVES * _sms(device) / B)


def _slots(P: int, B: int, device: torch.device) -> int:
    """Blocks per batch element, each owning a contiguous range of the P
    items (pairs): about 8 per SM over the grid, never more than items."""
    return max(1, min(P, _grid_blocks(B, device)))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_width(d: int) -> None:
    if d != D_KERNEL:
        raise ValueError(f"the CUDA kernels are built for d={D_KERNEL}, got d={d}")


def _check_passes(passes: int) -> int:
    if passes not in PASSES:
        raise ValueError(f"passes={passes}: expected one of {PASSES}")
    return passes


def _storage_code(dtype: torch.dtype) -> int:
    if dtype not in STORAGE_CODES:
        raise TypeError(f"x1 storage {dtype}: expected one of {list(STORAGE_CODES)}")
    return STORAGE_CODES[dtype]


def reduce_slots(partial: torch.Tensor) -> torch.Tensor:
    """``(G, S, N)`` → ``(G, N)`` through ``pf_reduce_slots``
    (``csrc/slot_reduce.cu``) on the plan of :func:`.reduce.reduce_plan`:
    the sum of :func:`.reduce.reduce_slots_ordered` on that plan, bit for
    bit."""
    G, S, N = partial.shape
    plan = reduce_plan(G, S, N, _sms(partial.device))
    out = torch.empty((G, N), device=partial.device, dtype=torch.float32)
    lib = _lib()
    _build.check(lib, lib.pf_reduce_slots(partial.data_ptr(), out.data_ptr(), G, S, N,
                                          plan.warps, int(plan.streaming), _stream()),
                 "reduce_slots")
    return out


def reduce_stats(partial: torch.Tensor) -> torch.Tensor:
    """``(B, S, L, 3d)`` per-block partials → ``(B, L, 3d)``, summed over
    the slots in the order of :func:`.reduce.reduce_plan`."""
    if _on_cpu(partial):
        return reduce_stats_plain(partial)
    B, S, L, d3 = partial.shape
    _check_width(d3 // 3)
    _require(partial, "partial", (B, S, L, 3 * D_KERNEL))
    stats = reduce_slots(partial.view(B, S, L * d3))
    LAUNCHES["reduce_stats"] += 1
    return stats.view(B, L, d3)


def _scratch(B: int, P: int, L: int, device, max_slots: int = 1 << 30
             ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Blocks per batch element, the per-pair row sums and the per-block
    column-stat partials of a kernel A."""
    if P < 1:
        raise ValueError("the pipeline needs at least one pair (two sequences)")
    S = min(_slots(P, B, device), max_slots)
    rowsum = torch.empty((B, P, 3, D_KERNEL), device=device, dtype=torch.float32)
    partial = torch.empty((B, S, L, 3 * D_KERNEL), device=device, dtype=torch.float32)
    return S, rowsum, partial


def kernel_p0(emb, ii, jj, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes=3,
              act_dtype=torch.float32):
    """``emb`` ``(B, n, L, d)`` fp32, ``ii/jj`` ``(P,)`` int32 → x1
    ``(B, P, L, d)`` stored as ``act_dtype``, stats ``(B, L, 3d)``."""
    storage = _storage_code(act_dtype)
    _check_passes(passes)
    if _on_cpu(emb, ii, jj, smask, pmask, rw.flat, cw.flat):
        return kernel_p0_plain(emb, ii, jj, smask, pmask, rw, cw, eps, passes, act_dtype)
    B, n, L, d = emb.shape
    P = ii.shape[0]
    _check_width(d)
    _require(emb, "emb", (B, n, L, d))
    _require(ii, "ii", (P,), torch.int32)
    _require(jj, "jj", (P,), torch.int32)
    _require(smask, "smask", (B, L))
    _require(pmask, "pmask", (B, P))
    _require_groups(row=(rw, ROW_SIZE, ROW_MMA_SIZE), col=(cw, COL_SIZE, COL_MMA_SIZE))
    S, rowsum, partial = _scratch(B, P, L, emb.device)
    x1 = torch.empty((B, P, L, d), device=emb.device, dtype=act_dtype)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_p0(
        emb.data_ptr(), ii.data_ptr(), jj.data_ptr(), x1.data_ptr(), smask.data_ptr(),
        pmask.data_ptr(), rw.flat.data_ptr(), rw.mma.data_ptr(), cw.flat.data_ptr(),
        cw.mma.data_ptr(), rowsum.data_ptr(), partial.data_ptr(), B, n, P, L, S, float(eps),
        passes, storage, _stream()), "kernel_p0")
    LAUNCHES["kernel_p0"] += 1
    return x1, reduce_stats(partial)


def kernel_a_only(x, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes=3):
    """``x`` ``(B, P, L, d)``, fp32 or bf16 → (x1, stats), x1 stored as x
    is.  On the card x1 is written in place over ``x`` (the returned x1 is
    ``x``)."""
    storage = _storage_code(x.dtype)
    _check_passes(passes)
    if _on_cpu(x, smask, pmask, rw.flat, cw.flat):
        return kernel_a_only_plain(x, smask, pmask, rw, cw, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d), STORAGE_CODES)
    _require(smask, "smask", (B, L))
    _require(pmask, "pmask", (B, P))
    _require_groups(row=(rw, ROW_SIZE, ROW_MMA_SIZE), col=(cw, COL_SIZE, COL_MMA_SIZE))
    S, rowsum, partial = _scratch(B, P, L, x.device)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_a_only(
        x.data_ptr(), smask.data_ptr(), pmask.data_ptr(), rw.flat.data_ptr(), rw.mma.data_ptr(),
        cw.flat.data_ptr(), cw.mma.data_ptr(), rowsum.data_ptr(), partial.data_ptr(), B, P, L,
        S, float(eps), passes, storage, _stream()), "kernel_a_only")
    LAUNCHES["kernel_a_only"] += 1
    return x, reduce_stats(partial)


def _gelu_code(gelu_mode: str) -> int:
    """The activation's kernel code (M and Z are built for each, at both
    storage types)."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r}: expected one of {GELU_MODES}")
    return GELU_MODES.index(gelu_mode)


def m_blocks(P: int, B: int, device: torch.device) -> int:
    """Kernel M's blocks per batch element: one block an SM (its shared
    memory and its 384 threads' registers fill one: two consumer warpgroups
    and a producer warpgroup), the grid no larger than
    the SM count where B allows, never more blocks than pairs."""
    return max(1, min(P, _sms(device) // B))


def _require_wg(**groups: Tuple[WeightGroup, int, int]) -> None:
    """Each group's flat buffer and kernel M's planes of it (:func:`pack_wg`):
    sizes, and the 16-byte alignment of the bulk copies."""
    for name, (g, size, wg_size) in groups.items():
        _require(g.flat, name, (size,))
        _require(g.wg, f"{name} (wgmma planes)", (wg_size,))
        if g.wg.data_ptr() % 16:
            raise ValueError(f"{name} (wgmma planes): not 16-byte aligned")


def kernel_m(x1, stats, smask, pmask, pair_count, bw: WeightGroup, rw: WeightGroup,
             cw: WeightGroup, eps, gelu_mode="exact", passes=3):
    """Block boundary: (x1, stats) of block i → (x1, stats) of block i+1,
    x1 fp32 or bf16.  On the card x1 is updated in place; the stats come in
    a new buffer.  At fp32 storage it runs ``pf_kernel_m`` (warpgroup MMA,
    ``csrc/axial_pipeline_m.cu``), at bf16 ``pf_kernel_m_bf16`` (the
    mma.sync bodies), each counted under its own key of :data:`LAUNCHES`."""
    _storage_code(x1.dtype)
    gelu = _gelu_code(gelu_mode)
    _check_passes(passes)
    if _on_cpu(x1, stats, smask, pmask, pair_count, bw.flat, rw.flat, cw.flat):
        return kernel_m_plain(x1, stats, smask, pmask, pair_count, bw, rw, cw, eps, gelu_mode,
                              passes)
    B, P, L, d = x1.shape
    _check_width(d)
    _require(x1, "x1", (B, P, L, d), STORAGE_CODES)
    _require(stats, "stats", (B, L, 3 * d))
    _require(smask, "smask", (B, L))
    _require(pmask, "pmask", (B, P))
    _require(pair_count, "pair_count", (B,))
    lib = _lib()
    if x1.dtype == torch.bfloat16:
        # the mma.sync design: its second pass reruns kernel B on the stored x1
        _require_groups(b=(bw, B_SIZE, B_MMA_SIZE), row=(rw, ROW_SIZE, ROW_MMA_SIZE),
                        col=(cw, COL_SIZE, COL_MMA_SIZE))
        S, rowsum, partial = _scratch(B, P, L, x1.device)
        _build.check(lib, lib.pf_kernel_m_bf16(
            x1.data_ptr(), stats.data_ptr(), smask.data_ptr(), pmask.data_ptr(),
            pair_count.data_ptr(), bw.flat.data_ptr(), bw.mma.data_ptr(), rw.flat.data_ptr(),
            rw.mma.data_ptr(), cw.flat.data_ptr(), cw.mma.data_ptr(), rowsum.data_ptr(),
            partial.data_ptr(), B, P, L, S, float(eps), gelu, passes, _stream()),
            "kernel_m_bf16")
        LAUNCHES["kernel_m_bf16"] += 1
        return x1, reduce_stats(partial)
    _require_wg(b=(bw, B_SIZE, B_WG_SIZE), row=(rw, ROW_SIZE, ROW_WG_SIZE),
                col=(cw, COL_SIZE, COL_WG_SIZE))
    G = m_blocks(P, B, x1.device)
    rowsum = torch.empty((B, P, M_CONSUMERS, 3, D_KERNEL), device=x1.device,
                         dtype=torch.float32)
    partial = torch.empty((B, M_CONSUMERS * G, L, 3 * D_KERNEL), device=x1.device,
                          dtype=torch.float32)
    _build.check(lib, lib.pf_kernel_m(
        x1.data_ptr(), stats.data_ptr(), smask.data_ptr(), pmask.data_ptr(),
        pair_count.data_ptr(), bw.flat.data_ptr(), bw.wg.data_ptr(), rw.flat.data_ptr(),
        rw.wg.data_ptr(), cw.flat.data_ptr(), cw.wg.data_ptr(), rowsum.data_ptr(),
        partial.data_ptr(), B, P, L, G, float(eps), gelu, passes, _stream()), "kernel_m")
    LAUNCHES["kernel_m"] += 1
    return x1, reduce_stats(partial)


def kernel_z(x1, stats, smask, pair_count, bw: WeightGroup, hw: WeightGroup, eps,
             gelu_mode="exact", passes=3):
    """Last block's kernel B + head → ``(B, P)`` distances; x1 fp32 or
    bf16, the head fp32."""
    storage = _storage_code(x1.dtype)
    gelu = _gelu_code(gelu_mode)
    _check_passes(passes)
    if _on_cpu(x1, stats, smask, pair_count, bw.flat, hw.flat):
        return kernel_z_plain(x1, stats, smask, pair_count, bw, hw, eps, gelu_mode, passes)
    B, P, L, d = x1.shape
    _check_width(d)
    _require(x1, "x1", (B, P, L, d), STORAGE_CODES)
    _require(stats, "stats", (B, L, 3 * d))
    _require(smask, "smask", (B, L))
    _require(pair_count, "pair_count", (B,))
    _require_groups(b=(bw, B_SIZE, B_MMA_SIZE), head=(hw, HEAD_SIZE, 0))
    if P < 1:
        raise ValueError("the pipeline needs at least one pair (two sequences)")
    S = _slots(P, B, x1.device)
    out = torch.empty((B, P), device=x1.device, dtype=torch.float32)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_z(
        x1.data_ptr(), stats.data_ptr(), smask.data_ptr(), pair_count.data_ptr(),
        bw.flat.data_ptr(), bw.mma.data_ptr(), hw.flat.data_ptr(), out.data_ptr(), B, P, L, S,
        float(eps), gelu, passes, storage, _stream()), "kernel_z")
    LAUNCHES["kernel_z"] += 1
    return out


# ---- the pipelined forward ------------------------------------------------

def pipeline_supported(n_seqs: int, seq_len: int, mxu_precision: str = "highest") -> bool:
    """True when the pipelined kernels serve this bucket shape, as JAX's rule
    gives it: site axes up to ``RESIDENT_SITES_MAX`` (1024) at fp32-grade
    products ("highest" / "float32"), up to ``RESIDENT_SITES_MAX_REDUCED``
    (2048) at reduced precision; longer ones take the L-tiled fused
    forward.  ``n_seqs`` does not enter.  The CUDA kernels have no site cap:
    the rule routes, it does not protect them."""
    cap = (axial_block.RESIDENT_SITES_MAX if passes_of(mxu_precision) == 3
           else axial_block.RESIDENT_SITES_MAX_REDUCED)
    return seq_len <= cap


def uses_gather(n_seqs: int, seq_len: int, d: int) -> bool:
    """Block 0 runs kernel P0 (in-kernel gather) rather than A-only."""
    return (n_seqs * seq_len * d * 4 <= P0_EMB_BUDGET_BYTES
            and n_seqs * (n_seqs - 1) // 2 <= P0_MAX_PAIRS)


def forward_fused_pipeline(
    weights: PipelineWeights,
    codes: torch.Tensor,
    site_mask: torch.Tensor,
    seq_mask: torch.Tensor,
    eps: float = 1e-5,
    gelu_mode: str = "exact",
    mxu_precision: str = "highest",
    act_dtype_name: str = "float32",
) -> torch.Tensor:
    """Full Phyloformer forward through the pipelined kernels.

    ``codes`` ``(B, n, L)`` integers, ``site_mask`` ``(B, L)`` and
    ``seq_mask`` ``(B, n)`` bool, all on one device.  ``mxu_precision``:
    "highest" / "float32" (three TF32 passes) or anything else (one pass);
    ``act_dtype_name``: x1's storage between the kernels, "float32" or
    "bfloat16" (compute stays fp32); ``gelu_mode``: the FFN's activation.
    Returns ``(B, P)`` distances, ``P = n(n-1)/2`` in upper-triangle order
    (padded pairs hold finite garbage).  The kernels run for CUDA tensors,
    the plain versions for CPU tensors.
    """
    if act_dtype_name not in ACT_DTYPES:
        raise ValueError(f"act_dtype_name={act_dtype_name!r}: expected one of "
                         f"{list(ACT_DTYPES)}")
    act_dtype = ACT_DTYPES[act_dtype_name]
    passes = passes_of(mxu_precision)
    device = codes.device
    b, n, l = codes.shape
    d = weights.embed_w.shape[1]
    i_np, j_np = pair_indices(n)
    ii = torch.as_tensor(i_np, device=device)
    jj = torch.as_tensor(j_np, device=device)

    # (B, n, L, d) fp32.  At bf16 parameters w + b is rounded to bf16, as JAX
    # adds two bf16 arrays, and block 0 takes it widened to fp32 (or x1's
    # storage type), as JAX's XLA-gather head does on hardware.
    emb = torch.relu((weights.embed_w[codes.long()] + weights.embed_b)
                     .to(weights.param_dtype)).float()
    smask = site_mask.to(torch.float32).contiguous()
    pmask = (seq_mask.index_select(1, ii.long())
             & seq_mask.index_select(1, jj.long())).to(torch.float32).contiguous()
    pair_count = pmask.sum(dim=1)

    if uses_gather(n, l, d):
        x1, stats = kernel_p0(emb, ii, jj, smask, pmask, weights.row[0], weights.col[0], eps,
                              passes, act_dtype)
    else:
        # the embedding is cast to the storage type before the gathers, so
        # both of them (and their sum) are storage-wide, as in JAX
        emb_s = emb.to(act_dtype)
        x0 = emb_s.index_select(1, ii.long()) + emb_s.index_select(1, jj.long())
        x1, stats = kernel_a_only(x0, smask, pmask, weights.row[0], weights.col[0], eps, passes)

    for i in range(len(weights.row) - 1):
        x1, stats = kernel_m(x1, stats, smask, pmask, pair_count, weights.b[i],
                             weights.row[i + 1], weights.col[i + 1], eps, gelu_mode, passes)

    return kernel_z(x1, stats, smask, pair_count, weights.b[-1], weights.head, eps, gelu_mode,
                    passes)
