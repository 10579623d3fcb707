"""Fused GroupNorm(+affine)+ReLU for channels-last maps, hand-written for
Hopper.

Replaces the Pallas kernel ``fused_group_norm_relu_pallas`` of
``tpuseg/kernels/fused_norm.py`` (line 74; its ``_stats_kernel`` and
``_apply_kernel``): GroupNorm over (N, V, C) channels-last maps with the
statistics per (sample, group), then the per-channel affine and an optional
ReLU.

What bounds it on the card: memory.  It does a handful of flops per element
against 2 reads and 1 write of the map, far below the card's balance point,
so the only lever is the bytes moved, and at the small maps of the deep
levels the launches.  The TPU version carried its sums from one grid step
to the next; CUDA blocks run in no order, so the design
(``csrc/fused_norm.cu``) is two launches over the same chunks of rows.  A
thread owns a 16-byte vector of channels (narrower where C needs it) and
every R-th row, so its channels, groups and affine are fixed and no
element needs a division.  Pass 1 sums x - shift and its square in fp32,
the shift being the sample's first value of the group, so that the sums do
not cancel where the Pallas formula ``s2 / count - mean**2``
(fused_norm.py:62) does (large mean); each block writes one partial per
(sample, chunk, group).  Pass 2 merges its sample's partials in float64 in
a fixed order at its start, so no launch of its own finalizes them, and
applies the normalization, the affine and the ReLU in one read and one
write.  Folding the statistics into the preceding conv's epilogue,
which would save the stats pass's read, is later work.

The backward (``csrc/fused_norm_bwd.cu``, replacing the JAX recompute
through ``_gn_relu_reference`` in ``fused_group_norm_relu_vjp``) is
memory-bound too: it reads x and the output gradient twice and writes dx
once.  It takes the per-(sample, group) mean and rstd that the forward
wrote, recomputes the normalized map and the ReLU mask from x (nothing of
the forward's size is saved but x itself), sums g·mask and g·mask·x̂ per
(sample, chunk, channel) in its first launch, and its second merges them in
float64 (dγ and dβ too) and writes dx = rstd·(γĝ − mean_grp(γĝ) −
x̂·mean_grp(γĝx̂)) in one elementwise pass.  Both merges run in a fixed
order, so two calls give the same bits.

``eps`` is an argument: flax ``nn.GroupNorm``, the default path of the JAX
model, uses 1e-6, while the JAX fused path runs at 1e-5.

``fused_group_norm_relu`` is an autograd node: on CPU tensors its forward
and backward run the plain versions; on CUDA tensors they launch the
kernels or raise.
"""
from __future__ import annotations

import torch

from tpuseg_torch.kernels import _build

# kernel launches by `fused_group_norm_relu` in this process, forward (one
# per call) and backward; plain calls not counted
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIZES = {torch.float32: 4, torch.bfloat16: 2}
_MAX_C = 1024  # must match csrc/fused_norm.cuh


def fused_group_norm_relu_plain(x, gamma, beta, groups: int = 8,
                                eps: float = 1e-6, relu: bool = True):
    """Plain PyTorch version: (N, *spatial, C) in/out, statistics and
    affine in fp32 (fp64 for fp64 input, as flax promotes them)."""
    shape = x.shape
    n, c = shape[0], shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(n, -1, groups, c // groups).to(acc)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, -1, c)
    y = y * gamma.to(acc) + beta.to(acc)
    if relu:
        y = torch.relu(y)
    return y.reshape(shape).to(x.dtype)


def fused_group_norm_relu_backward_plain(x, gamma, beta, grad_y,
                                        groups: int = 8, eps: float = 1e-6,
                                        relu: bool = True):
    """Plain PyTorch backward of ``fused_group_norm_relu_plain``: the
    kernel's formula in torch ops, fp32 statistics (fp64 for fp64 input).
    Returns (dx in ``x.dtype``, dgamma in ``gamma.dtype``, dbeta in
    ``beta.dtype``)."""
    n, c = x.shape[0], x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(n, -1, groups, c // groups).to(acc)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xg - mean) * rstd).reshape(n, -1, c)
    g = grad_y.reshape(n, -1, c).to(acc)
    if relu:
        g = g * (xhat * gamma.to(acc) + beta.to(acc) > 0)
    dbeta = g.sum(dim=(0, 1))
    dgamma = (g * xhat).sum(dim=(0, 1))
    dxhat = (g * gamma.to(acc)).reshape(xg.shape)
    xh = xhat.reshape(xg.shape)
    dx = rstd * (dxhat - dxhat.mean(dim=(1, 3), keepdim=True)
                 - xh * (dxhat * xh).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


# blocks to aim for over all samples (2 per SM of the H100: every block of
# the second launch merges all its sample's partials first, so fewer and
# longer chunks), and the fewest elements a block takes
_TARGET_BLOCKS = 264
_MIN_ELEMS = 8192


def _chunking(n: int, v: int, c: int):
    """Rows per chunk and the number of chunks of each sample: about
    ``_TARGET_BLOCKS`` blocks over the n samples, none under ``_MIN_ELEMS``
    elements unless the map is smaller.  Both launches of a call use the
    same chunks."""
    chunks = max(1, min(-(-_TARGET_BLOCKS // n), -(-(v * c) // _MIN_ELEMS)))
    rows = -(-v // chunks)
    return rows, -(-v // rows)


def _vec_elems(c: int, dtype: torch.dtype) -> int:
    """Channels per vector: the widest of 16 bytes and its halves that
    divides C (a C the width does not divide takes a narrower vector, down
    to one element)."""
    ve = 16 // _SIZES[dtype]
    while c % ve:
        ve //= 2
    return ve


def _vec_for(c: int, *tensors) -> int:
    """``_vec_elems``, narrowed until every tensor's address is aligned to it."""
    ve = _vec_elems(c, tensors[0].dtype)
    size = tensors[0].element_size()
    while ve > 1 and any(t.data_ptr() % (ve * size) for t in tensors):
        ve //= 2
    return ve


def _launch(x, gamma32, beta32, groups: int, eps: float, relu: bool):
    """Forward launches; returns (y, stats), stats (n, groups, 2) holding
    each (sample, group)'s mean and rstd."""
    global LAUNCHES
    n, c = x.shape[0], x.shape[-1]
    v = x.numel() // (n * c)
    rows, n_chunks = _chunking(n, v, c)
    y = torch.empty_like(x)
    # one allocation: each (sample, group)'s mean and rstd, then the partials
    scratch = torch.empty(n * (n_chunks + 1) * groups * 2, dtype=torch.float32,
                          device=x.device)
    stats = scratch[:n * groups * 2].view(n, groups, 2)
    partial = scratch.data_ptr() + stats.numel() * 4
    lib = _build.library()
    with _build.on_device(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_group_norm_relu(
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), y.data_ptr(),
            partial, stats.data_ptr(), n, v, c, groups, rows,
            n_chunks, float(eps), int(bool(relu)), _vec_for(c, x, y),
            _DTYPES[x.dtype], stream,
        )
    _build.check(err, "fused_group_norm_relu")
    LAUNCHES += 1
    return y, stats


def _launch_backward(x, grad_y, stats, gamma32, beta32, groups: int,
                     relu: bool):
    """Backward launches; returns (dx, dgamma, dbeta), the last two fp32."""
    global BWD_LAUNCHES
    n, c = x.shape[0], x.shape[-1]
    v = x.numel() // (n * c)
    rows, n_chunks = _chunking(n, v, c)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    partial = torch.empty((n, n_chunks, c, 2), dtype=torch.float32,
                          device=x.device)
    lib = _build.library()
    with _build.on_device(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_group_norm_relu_bwd(
            x.data_ptr(), grad_y.data_ptr(), stats.data_ptr(),
            gamma32.data_ptr(), beta32.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), partial.data_ptr(), n, v, c,
            groups, rows, n_chunks, int(bool(relu)), _vec_for(c, x, grad_y, dx),
            _DTYPES[x.dtype], stream,
        )
    _build.check(err, "fused_group_norm_relu backward")
    BWD_LAUNCHES += 1
    return dx, dgamma, dbeta


class _FusedGroupNormReLU(torch.autograd.Function):
    """The op as an autograd node: kernels for CUDA tensors, the plain
    versions for CPU tensors.  Saves x and, on the card, the forward's
    per-(sample, group) mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, relu):
        ctx.groups, ctx.eps, ctx.relu = groups, eps, relu
        if x.device.type == "cpu":
            ctx.save_for_backward(x, gamma, beta)
            return fused_group_norm_relu_plain(x, gamma, beta, groups, eps, relu)
        gamma32 = gamma.float().contiguous()  # no graph inside forward
        beta32 = beta.float().contiguous()
        y, stats = _launch(x, gamma32, beta32, groups, eps, relu)
        ctx.save_for_backward(x, gamma, beta, stats, gamma32, beta32)
        return y

    @staticmethod
    def backward(ctx, grad_y):
        if grad_y.device.type == "cpu":
            x, gamma, beta = ctx.saved_tensors
            return fused_group_norm_relu_backward_plain(
                x, gamma, beta, grad_y, ctx.groups, ctx.eps, ctx.relu) \
                + (None, None, None)
        x, gamma, beta, stats, gamma32, beta32 = ctx.saved_tensors
        dx, dgamma, dbeta = _launch_backward(
            x, grad_y.to(x.dtype).contiguous(), stats, gamma32, beta32,
            ctx.groups, ctx.relu)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                None, None, None)


def fused_group_norm_relu(x, gamma, beta, groups: int = 8, eps: float = 1e-6,
                          relu: bool = True):
    """GroupNorm(groups) + affine (+ ReLU) on a channels-last map.

    ``x`` (N, *spatial, C) contiguous, float32 or bfloat16; ``gamma``,
    ``beta`` (C,).  Statistics in fp32 (merged in fp64), output ``x.dtype``.
    Differentiable in x, gamma and beta.  CPU tensors take the plain
    versions; CUDA tensors the kernels, forward and backward."""
    on_cpu = (x.device.type == "cpu" and gamma.device.type == "cpu"
              and beta.device.type == "cpu")
    if not on_cpu and (x.device.type != "cuda" or gamma.device != x.device
                       or beta.device != x.device):
        raise ValueError(
            f"fused_group_norm_relu: x on {x.device}, gamma on {gamma.device},"
            f" beta on {beta.device}; all must be on one CUDA device"
        )
    if not on_cpu and x.dtype not in _DTYPES:
        raise TypeError(
            f"fused_group_norm_relu: x dtype {x.dtype} not in {list(_DTYPES)}"
        )
    c = x.shape[-1]
    if x.dim() < 2 or c > _MAX_C or groups < 1 or c % groups:
        raise ValueError(
            f"fused_group_norm_relu: shape {tuple(x.shape)} with {groups} "
            f"groups (C must divide into groups and be <= {_MAX_C})"
        )
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError("fused_group_norm_relu: gamma and beta must be (C,)")
    if not on_cpu and not x.is_contiguous():
        raise ValueError("fused_group_norm_relu: x must be contiguous")
    return _FusedGroupNormReLU.apply(x, gamma, beta, groups, eps, relu)
