"""T5 attention core: the port of ops/flash.py's kernels (K1 forward, K2a /
K2b backward) and of the per-head core of ops/flash_v3.py's backward (K4).

Forward, per head: out = softmax(q . k^T + pos[h] + key_mask[b]) . v, with
no 1/sqrt(dk) scaling, and the softmax statistics (m, l). It replaces
``flash_attention_forward`` (pacednegatives_tpu/ops/flash.py:94) and
``flash_attention_forward_v2`` (ops/flash.py:480) with one CUDA kernel,
``csrc/t5_attention_fwd.cu``, and is the core of the fused block (K3,
ops/flash_v3.py). ``flash_attention_forward_v2`` is the same function.

Backward of the fused block (``attention_backward``): from (m, l) and the
output cotangent g, the recomputed out, dq, dk, dv and dpos = sum over the
batch of ds, with the numerics of ``_v3_bwd_kernel``
(pacednegatives_tpu/ops/flash_v3.py:196-268), in
``csrc/t5_attention_bwd.cu`` (a TMA-fed wgmma dq pass and dk/dv pass). It
is the core of the fused block's backward (K4); q/k/v/g and the outputs are
strided (B, H, L, dk) views.

Backward of the chunked path's kernel route (``flash_attention_backward``,
K2a, and ``flash_attention_backward_v2``, K2b; ops/flash.py:316, 599): from
(m, l), delta = sum g * out (``dcap``, given) and the fp32 cotangent g, the
fp32 dq, dk, dv and dpos. Both run K4's two passes (``csrc/
t5_attention_bwd.cuh``) on the tensor cores. K2b rounds p, g and ds to q's
dtype as the products' operands (``csrc/t5_attention_bwd.cu``). K2a
multiplies fp32 operands: it splits g, p and ds each into three bf16 terms
(``split_bf16``), which hold an fp32 value exactly, and sums their products
(``csrc/t5_attention_bwd_fp32.cu``). ``flash_v2_eligible`` chooses between
them as the JAX package does; both go through one C entry point.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors. Unlike the TPU kernels they take any
lengths: the CUDA kernels mask ragged tiles themselves, so there are no
block-size arguments.

Forward numerics of both versions follow the TPU kernels: scores in fp32,
the UNNORMALISED probabilities rounded to v's dtype before P . V (fp32
accumulation), division by l = max(sum, 1e-30) afterwards.
"""

from __future__ import annotations

import ctypes

import torch

from pacednegatives_tpu_torch import kernels

NEG_INF = -1e9  # additive mask value (pacednegatives_tpu/ops/flash.py:40)


def flash_attention_reference(q, k, v, pos_bias, key_mask):
    """Dense reference with the same inputs and layout (ops/flash.py:167):
    normalised softmax weights rounded to v's dtype, then P . V."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos_bias[None].float() + key_mask[:, None, None, :].float()
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w.to(v.dtype), v)


def flash_attention_forward_plain(q, k, v, pos, key_mask, out_dtype=None,
                                  *, out=None):
    """Plain PyTorch version of ``flash_attention_forward``.

    q (B, H, Lq, dk), k/v (B, H, Lk, dk), pos (H, Lq, Lk), key_mask (B, Lk)
    additive. Returns (out (B, H, Lq, dk) in ``out_dtype`` (default q's),
    m (B, H, Lq) fp32, l (B, H, Lq) fp32). With ``out`` given, the result is
    written into it (any strides) and ``out`` is returned."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos[None].float() + key_mask[:, None, None, :].float()
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]
    if out is None:
        return o.to(out_dtype or q.dtype), m, l
    out.copy_(o)
    return out, m, l


def _check_qkv(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernel: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"attention kernel: {name} must be 4-D with a contiguous head "
            f"dimension and other strides multiples of 8 (strides "
            f"{t.stride()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel: {name} must be 16-byte aligned")


def flash_attention_forward(q, k, v, pos, key_mask, out_dtype=None, *,
                            out=None):
    """-> (out (B, H, Lq, dk), m (B, H, Lq), l (B, H, Lq)).

    CPU tensors: ``flash_attention_forward_plain``. CUDA tensors: the kernel,
    which takes bf16 q/k/v of dk 64 or 128 with a contiguous head dimension
    and any other strides that are multiples of 8 (so views into a fused
    qkv buffer work without a copy); k and v must share strides; pos
    (H, Lq, Lk) and key_mask (B, Lk) fp32 contiguous; out bf16 or fp32. With
    ``out`` given (shape (B, H, Lq, dk), head dimension contiguous, e.g. a
    transposed view of a (B, Lq, H, dk) buffer) the kernel writes into it."""
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, pos, key_mask,
                                             out_dtype, out=out)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, pos, key_mask)):
        raise ValueError("attention kernel: all inputs must be on one CUDA device")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_qkv(t, name)
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, dk) or v.shape != k.shape:
        raise ValueError(
            f"attention kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if k.stride() != v.stride():
        raise ValueError("attention kernel: k and v must share strides")
    if dk not in (64, 128):
        raise ValueError(f"attention kernel: dk must be 64 or 128, got {dk}")
    if (pos.dtype != torch.float32 or tuple(pos.shape) != (H, Lq, Lk)
            or not pos.is_contiguous()):
        raise ValueError(
            f"attention kernel: pos must be contiguous fp32 {(H, Lq, Lk)}, "
            f"got {pos.dtype} {tuple(pos.shape)}"
        )
    if (key_mask.dtype != torch.float32 or tuple(key_mask.shape) != (B, Lk)
            or not key_mask.is_contiguous()):
        raise ValueError(
            f"attention kernel: key_mask must be contiguous fp32 {(B, Lk)}, "
            f"got {key_mask.dtype} {tuple(key_mask.shape)}"
        )
    if out is None:
        out = torch.empty((B, H, Lq, dk), dtype=out_dtype or q.dtype, device=dev)
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel: out must be bf16 or fp32, got {out.dtype}")
    if (tuple(out.shape) != (B, H, Lq, dk) or out.device != dev
            or out.stride(3) != 1 or any(s % 2 for s in out.stride()[:3])
            or out.data_ptr() % 8):
        raise ValueError(
            f"attention kernel: out must be {(B, H, Lq, dk)} on {dev} with a "
            f"contiguous head dimension and even strides, got "
            f"{tuple(out.shape)} strides {out.stride()}"
        )
    m = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    rc = kernels.library().pnt_t5_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3],
        pos.data_ptr(), key_mask.data_ptr(),
        out.data_ptr(), *out.stride()[:3], int(out.dtype == torch.float32),
        m.data_ptr(), l.data_ptr(), B, H, Lq, Lk, dk,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "t5_attention_fwd")
    flash_attention_forward.launches += 1
    return out, m, l


flash_attention_forward.launches = 0  # kernel launches; CPU route not counted

# K1b (ops/flash.py:480) is the same kernel: the CUDA kernel holds no keys
# resident, so the TPU's v1 / v2 split has no counterpart in the forward
flash_attention_forward_v2 = flash_attention_forward


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def attention_backward_plain(q, k, v, g, pos, key_mask, m, l, *, dq=None,
                             dk=None, dv=None, out=None):
    """Plain PyTorch version of ``attention_backward``, in the arithmetic of
    the TPU backward kernel (flash_v3.py:221-268): p = exp(s - m) / l is
    normalised before it is rounded to v's dtype; the recomputed o and
    delta = sum g * o stay fp32; dv = bf16(p)^T g, dp = g v^T,
    ds = p (dp - delta) in fp32; dq = bf16(ds) k and dk = bf16(ds)^T q with
    fp32 accumulation; dpos = sum over the batch of ds.

    Shapes as ``attention_backward``. Returns (dq, dk, dv, out, dpos); with
    ``dq``/``dk``/``dv``/``out`` given, the results are written into them."""
    cdt = v.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos[None].float() + key_mask[:, None, None, :].float()
    p = torch.exp(s - m[..., None]) / l[..., None]
    p_c = p.to(cdt).float()
    o = torch.matmul(p_c, v.float())
    g_c = g.to(cdt).float()
    delta = (g.float() * o).sum(dim=-1)
    dv_ = torch.matmul(p_c.transpose(-1, -2), g_c)
    dp = torch.matmul(g_c, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    ds_c = ds.to(cdt).float()
    dq_ = torch.matmul(ds_c, k.float())
    dk_ = torch.matmul(ds_c.transpose(-1, -2), q.float())
    results = []
    for val, buf in ((dq_, dq), (dk_, dk), (dv_, dv), (o, out)):
        if buf is None:
            results.append(val.to(cdt))
        else:
            buf.copy_(val)
            results.append(buf)
    return (*results, ds.sum(dim=0))


def ds_error_bound(q, k, v, g, pos, key_mask, m, l, dcap=None):
    """-> (bound, ds), both (B, H, Lq, Lk) float64: an elementwise bound on
    the difference between two fp32 evaluations of the backward's
    ds = p (dp - delta) that differ only in summation order and rounding,
    and ds itself in float64. K4's numerics with ``dcap`` None (delta
    recomputed from o), K2b's with ``dcap`` given (g rounded to bf16);
    inputs as ``attention_backward``, on any device.

    With u = 2^-24 and gamma(n) = 3 n u (an n-term fp32 sum in any order,
    on both sides, the tensor cores' truncating accumulation included), it
    is (p eps_p + TINY) |dp - delta| + p (eps_dp + eps_delta + 4u (|dp| +
    |delta|)), from the plain version's own intermediates, where:
    - eps_p = gamma(dk) |q| |k|^T + 4u (|q k^T| + |pos| + |m|) + 16u: s, its
      bias sums, exp and 1 / l on both sides (the kernels take 2^x and 1/x
      from the MUFU, ~2 ulps each);
    - TINY = 2^-126: the kernels flush p below the smallest normal fp32 to
      0, the plain versions keep it subnormal;
    - eps_dp = gamma(dk) |g| |v|^T;
    - K4 only: eps_delta = sum_c |g| ((flip + TINY + gamma(Lk) p) |v|) +
      gamma(dk) sum_c |g o|, with flip = bf16(p (1 + eps_p)) -
      bf16(p (1 - eps_p)) how far apart the two sides' bf16(p) in
      o = bf16(p) v can round (one bf16 ulp where p lies that close to a
      rounding boundary, else 0)."""
    f64 = torch.float64
    u = 2.0**-24
    TINY = 2.0**-126  # p below it may be flushed to 0 (or subnormal)
    dk = q.shape[-1]
    Lk = k.shape[2]
    qf, kf, vf = (t.to(f64) for t in (q, k, v))
    gf = g.to(torch.bfloat16).to(f64)
    mf = m.to(f64)[..., None]
    qk = torch.matmul(qf, kf.transpose(-1, -2))
    s = qk + pos[None].to(f64) + key_mask[:, None, None, :].to(f64)
    p = torch.exp(s - mf) / l.to(f64)[..., None]
    eps_p = (_gamma(dk) * torch.matmul(qf.abs(), kf.abs().transpose(-1, -2))
             + 4 * u * (qk.abs() + pos[None].to(f64).abs() + mf.abs())
             + 16 * u)
    del qk, s
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    eps_dp = _gamma(dk) * torch.matmul(gf.abs(), vf.abs().transpose(-1, -2))
    if dcap is None:
        o = torch.matmul(p.to(v.dtype).to(f64), vf)
        delta = (gf * o).sum(dim=-1)
        # what bf16(p) can be on either side: p within eps_p (and TINY) of p
        flip = ((p * (1 + eps_p)).to(v.dtype).to(f64)
                - (p * (1 - eps_p)).to(v.dtype).to(f64))
        eps_delta = ((gf.abs() * torch.matmul(flip + TINY + _gamma(Lk) * p,
                                              vf.abs())).sum(dim=-1)
                     + _gamma(dk) * (gf * o).abs().sum(dim=-1))[..., None]
        del o, flip
    else:
        delta, eps_delta = dcap.to(f64), 0.0
    delta = delta[..., None]
    bound = ((p * eps_p + TINY) * (dp - delta).abs()
             + p * (eps_dp + eps_delta + 4 * u * (dp.abs() + delta.abs())))
    return bound, p * (dp - delta)


def _gamma(n: int) -> float:
    return 3.0 * n * 2.0**-24


def dpos_error_bound(q, k, v, g, pos, key_mask, m, l, dcap=None):
    """Elementwise bound (H, Lq, Lk, float64) on the difference between two
    fp32 evaluations of dpos = sum_b ds (the kernel against its plain
    version, or the plain version against exact arithmetic):
    ``ds_error_bound`` summed over the batch, plus the batch sum's own
    gamma(B) sum_b |ds|. Arguments as ``ds_error_bound``."""
    bound, ds = ds_error_bound(q, k, v, g, pos, key_mask, m, l, dcap)
    return bound.sum(dim=0) + _gamma(q.shape[0]) * ds.abs().sum(dim=0)


def _check_out(t: torch.Tensor, name: str, shape, dev) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernel: {name} must be bfloat16, got {t.dtype}")
    if (tuple(t.shape) != tuple(shape) or t.device != dev or t.stride(3) != 1
            or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4):
        raise ValueError(
            f"attention kernel: {name} must be {tuple(shape)} on {dev} with a "
            f"contiguous head dimension and even strides, got "
            f"{tuple(t.shape)} strides {t.stride()}"
        )


def _check_stats(t: torch.Tensor, name: str, shape) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"attention kernel: {name} must be contiguous fp32 "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )


# batch rows per dpos partial: each group of rows adds its ds into one
# (H, Lq, Lk) fp32 slab in a fixed order, and a last pass sums the slabs
DPOS_ROWS_PER_GROUP = 4


def _dpos_buffers(B, H, Lq, Lk, dev):
    """dpos (H, Lq, Lk) and the group partials' scratch (dpos itself when
    the batch is one group: the kernels then write it directly)."""
    dpos = torch.empty((H, Lq, Lk), dtype=torch.float32, device=dev)
    groups = -(-B // DPOS_ROWS_PER_GROUP)
    if groups == 1:
        return dpos, dpos
    return dpos, torch.empty((groups, H, Lq, Lk), dtype=torch.float32,
                             device=dev)


def attention_backward(q, k, v, g, pos, key_mask, m, l, *, dq=None, dk=None,
                       dv=None, out=None):
    """-> (dq, dk, dv, out, dpos).

    q (B, H, Lq, dk), k/v (B, H, Lk, dk), g (B, H, Lq, dk) the cotangent of
    the attention output, pos (H, Lq, Lk) and key_mask (B, Lk) additive fp32,
    m/l (B, H, Lq) the forward's softmax statistics. dq/dk/dv/out are the
    gradients and the recomputed attention output, in v's dtype; dpos
    (H, Lq, Lk) fp32 is ds summed over the batch.

    CPU tensors: ``attention_backward_plain``. CUDA tensors: the kernels of
    ``csrc/t5_attention_bwd.cu``, which take bf16 q/k/v/g of dk 64 or 128
    with a contiguous head dimension and other strides that are multiples of
    8, k and v sharing strides; dq, dk/dv (sharing strides) and out, when
    given, are bf16 views with a contiguous head dimension and even strides
    (e.g. views into a fused (B, L, 3*H*dk) buffer). dpos is summed in a
    fixed order: two runs on the same inputs give the same bits."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, g, pos, key_mask, m, l,
                                        dq=dq, dk=dk, dv=dv, out=out)
    dev = q.device
    if dev.type != "cuda" or any(
            t.device != dev for t in (k, v, g, pos, key_mask, m, l)):
        raise ValueError("attention kernel: all inputs must be on one CUDA device")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g")):
        _check_qkv(t, name)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    if (k.shape != (B, H, Lk, d) or v.shape != k.shape
            or g.shape != q.shape):
        raise ValueError(
            f"attention kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} g {tuple(g.shape)} do not match"
        )
    if k.stride() != v.stride():
        raise ValueError("attention kernel: k and v must share strides")
    if d not in (64, 128):
        raise ValueError(f"attention kernel: dk must be 64 or 128, got {d}")
    _check_stats(pos, "pos", (H, Lq, Lk))
    _check_stats(key_mask, "key_mask", (B, Lk))
    _check_stats(m, "m", (B, H, Lq))
    _check_stats(l, "l", (B, H, Lq))
    new = lambda L: torch.empty((B, H, L, d), dtype=torch.bfloat16, device=dev)
    dq = new(Lq) if dq is None else dq
    dk = new(Lk) if dk is None else dk
    dv = new(Lk) if dv is None else dv
    out = new(Lq) if out is None else out
    for t, name, L in ((dq, "dq", Lq), (dk, "dk", Lk), (dv, "dv", Lk),
                       (out, "out", Lq)):
        _check_out(t, name, (B, H, L, d), dev)
    if dk.stride() != dv.stride():
        raise ValueError("attention kernel: dk and dv must share strides")
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    dpos, dpos_part = _dpos_buffers(B, H, Lq, Lk, dev)
    rc = kernels.library().pnt_t5_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3],
        g.data_ptr(), *g.stride()[:3],
        pos.data_ptr(), key_mask.data_ptr(), m.data_ptr(), l.data_ptr(),
        dq.data_ptr(), *dq.stride()[:3],
        dk.data_ptr(), dv.data_ptr(), *dk.stride()[:3],
        out.data_ptr(), *out.stride()[:3],
        delta.data_ptr(), dpos_part.data_ptr(), dpos.data_ptr(),
        B, H, Lq, Lk, d, DPOS_ROWS_PER_GROUP,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "t5_attention_bwd")
    attention_backward.launches += 1
    return dq, dk, dv, out, dpos


attention_backward.launches = 0  # kernel launches; CPU route not counted


# ---------------------------------------------------------------------------
# Backward of the chunked path's kernel route (K2a, K2b)
# ---------------------------------------------------------------------------


def flash_v2_eligible(H: int, Lq: int, Lk: int, dk: int) -> bool:
    """The JAX package's choice between K2b and K2a (ops/flash.py:443-448):
    128-aligned lengths, dk 64 or 128, and the TPU kernel's VMEM residents
    (k + v, pos + dpos) within 48 MiB. Kept as it is so that both packages
    run the same numerics on the same shapes."""
    resident = H * Lk * dk * 2 * 2 + 2 * H * Lq * Lk * 4  # k+v, pos+dpos
    return (
        Lq % 128 == 0 and Lk % 128 == 0 and dk in (64, 128)
        and resident <= 48 * 1024 * 1024
    )


def _probs(q, k, pos, key_mask, m, l):
    """p = exp(s - m) / l in fp32, s = q . k^T + pos + key_mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos[None].float() + key_mask[:, None, None, :].float()
    return torch.exp(s - m[..., None]) / l[..., None]


def flash_attention_backward_plain(q, k, v, pos, key_mask, m, l, dcap, g):
    """Plain PyTorch version of ``flash_attention_backward`` (K2a), in the
    arithmetic of the TPU kernels (flash.py:215-232, 277-298): every
    product takes fp32 operands; ds = p (g . v^T - dcap). Returns fp32
    (dq, dk, dv, dpos), dpos = sum over the batch of ds."""
    p = _probs(q, k, pos, key_mask, m, l)
    g = g.float()
    ds = p * (torch.matmul(g, v.float().transpose(-1, -2)) - dcap[..., None])
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), g)
    return dq, dk, dv, ds.sum(dim=0)


def flash_attention_backward_v2_plain(q, k, v, pos, key_mask, m, l, dcap, g):
    """Plain PyTorch version of ``flash_attention_backward_v2`` (K2b), in the
    arithmetic of the TPU kernel (flash.py:545-576): p in fp32, then bf16(p),
    bf16(g) and bf16(ds) (q's dtype) as the products' operands with fp32
    accumulation; ds and dpos from the unrounded p. Returns fp32
    (dq, dk, dv, dpos)."""
    cdt = q.dtype
    p = _probs(q, k, pos, key_mask, m, l)
    g_c = g.float().to(cdt).float()
    dv = torch.matmul(p.to(cdt).float().transpose(-1, -2), g_c)
    dp = torch.matmul(g_c, v.float().transpose(-1, -2))
    ds = p * (dp - dcap[..., None])
    ds_c = ds.to(cdt).float()
    dq = torch.matmul(ds_c, k.float())
    dk = torch.matmul(ds_c.transpose(-1, -2), q.float())
    return dq, dk, dv, ds.sum(dim=0)


def split_bf16(x: torch.Tensor, terms: int = 3) -> list[torch.Tensor]:
    """fp32 ``x`` as ``terms`` bf16 tensors whose sum approximates it: term 0
    is x rounded to bf16 (nearest even), each further term the rounding of
    what the earlier ones leave (an exact fp32 difference). Three terms hold
    every fp32 value of magnitude >= 2^-110 exactly (x - x0 has at most 15
    significant bits, x - x0 - x1 at most 7); below that bf16's subnormal
    spacing leaves at most 2^-134. Two terms leave up to 2^-16 |x|. The
    plain version of K2a's split (``split_g_kernel`` and ``to_frags`` in
    ``csrc/``)."""
    rest = x.float()
    out = []
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


def _core_backward(q, k, v, pos, key_mask, m, l, dcap, g, fp32_operands):
    """Check the inputs and launch ``pnt_t5_attention_core_bwd``."""
    dev = q.device
    if dev.type != "cuda" or any(
            t.device != dev for t in (k, v, pos, key_mask, m, l, dcap, g)):
        raise ValueError("attention kernel: all inputs must be on one CUDA device")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_qkv(t, name)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    if (k.shape != (B, H, Lk, d) or v.shape != k.shape
            or g.shape != q.shape):
        raise ValueError(
            f"attention kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} g {tuple(g.shape)} do not match"
        )
    if k.stride() != v.stride():
        raise ValueError("attention kernel: k and v must share strides")
    if d not in (64, 128):
        raise ValueError(f"attention kernel: dk must be 64 or 128, got {d}")
    if g.dtype != torch.float32:
        raise TypeError(f"attention kernel: g must be float32, got {g.dtype}")
    if (g.stride(3) != 1 or any(s % 4 for s in g.stride()[:3])
            or g.data_ptr() % 16):
        raise ValueError(
            f"attention kernel: g must have a contiguous head dimension, "
            f"other strides multiples of 4 and 16-byte alignment (strides "
            f"{g.stride()})"
        )
    _check_stats(pos, "pos", (H, Lq, Lk))
    _check_stats(key_mask, "key_mask", (B, Lk))
    for t, name in ((m, "m"), (l, "l"), (dcap, "dcap")):
        _check_stats(t, name, (B, H, Lq))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dq, dk, dv = new(B, H, Lq, d), new(B, H, Lk, d), new(B, H, Lk, d)
    dpos, dpos_part = _dpos_buffers(B, H, Lq, Lk, dev)
    lib = kernels.library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    # K2b: g rounded to bf16 (flash.py:555); K2a: g's three bf16 planes and
    # the dq partials of the key chunks
    nbytes = ctypes.c_longlong()
    kernels.check(lib.pnt_t5_attention_core_bwd_scratch(
        B, H, Lq, Lk, d, int(fp32_operands), index, ctypes.byref(nbytes)),
        "t5_attention_core_bwd")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    rc = lib.pnt_t5_attention_core_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], g.data_ptr(), *g.stride()[:3],
        pos.data_ptr(), key_mask.data_ptr(), m.data_ptr(), l.data_ptr(),
        dcap.data_ptr(), scratch.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dpos_part.data_ptr(), dpos.data_ptr(),
        B, H, Lq, Lk, d, DPOS_ROWS_PER_GROUP, int(fp32_operands), index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "t5_attention_core_bwd")
    return dq, dk, dv, dpos


def flash_attention_backward(q, k, v, pos, key_mask, m, l, dcap, g):
    """K2a -> fp32 (dq (B, H, Lq, dk), dk, dv (B, H, Lk, dk), dpos (H, Lq,
    Lk)).

    q (B, H, Lq, dk), k/v (B, H, Lk, dk); pos (H, Lq, Lk) and key_mask
    (B, Lk) additive fp32; m, l (B, H, Lq) the forward's statistics; dcap
    (B, H, Lq) = sum g * out; g (B, H, Lq, dk) fp32 the cotangent of the
    attention output. CPU tensors: ``flash_attention_backward_plain``. CUDA
    tensors: ``csrc/t5_attention_bwd_fp32.cu`` (each fp32 operand as three
    bf16 terms on the tensor cores), which takes bf16 q/k/v of dk 64 or 128
    (head dimension contiguous, other strides multiples of 8, k and v
    sharing strides), fp32 g (head dimension contiguous, other strides
    multiples of 4) and contiguous fp32 pos / key_mask / m / l / dcap. dpos
    is summed in a fixed order: two runs on the same inputs give the same
    bits."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, pos, key_mask, m, l,
                                              dcap, g)
    out = _core_backward(q, k, v, pos, key_mask, m, l, dcap, g, True)
    flash_attention_backward.launches += 1
    return out


flash_attention_backward.launches = 0  # kernel launches; CPU route not counted


def flash_attention_backward_v2(q, k, v, pos, key_mask, m, l, dcap, g):
    """K2b: as ``flash_attention_backward`` with bf16(p), bf16(g) and
    bf16(ds) as the products' operands. CPU tensors:
    ``flash_attention_backward_v2_plain``; CUDA tensors: K4's TMA + wgmma
    kernels with fp32 g rounded to bf16 on the card, and the same input
    rules."""
    if q.device.type == "cpu":
        return flash_attention_backward_v2_plain(q, k, v, pos, key_mask, m,
                                                 l, dcap, g)
    out = _core_backward(q, k, v, pos, key_mask, m, l, dcap, g, False)
    flash_attention_backward_v2.launches += 1
    return out


flash_attention_backward_v2.launches = 0  # kernel launches; CPU route not counted
