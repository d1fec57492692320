"""Mixture-of-experts pieces: the sigmoid router, token dispatch by expert,
the grouped bf16 GEMM over the experts a rank holds (M1), and the weighted
combine.

An expert layer is told which experts it holds (``first`` and ``held``
of ``n_routed_experts``): the router scores every expert and picks its
top k, and the layer computes the held experts' part of the result for the
tokens routed to them. Nothing stands in for the experts held elsewhere
or for their exchange.

The dispatch buffer. ``dispatch_plan`` sorts the (token, slot) pairs
routed to held experts by expert, token order kept, and gives each expert
a segment of rows that starts at a multiple of ``BLOCK`` (128, the
kernel's row tile), zero rows filling each segment up to the next
multiple. The per-expert counts and offsets stay on the device; the
buffer's size, the end of the last segment, is read back once a layer
(``host_sync("moe.sizes")``), so that the buffer and everything computed
over it (the experts' GEMMs, the SwiGLU, the saved activations) has the
rows the pairs fill and no more. Sized for the worst case instead (every
token's k pairs on held experts: 6 rows a token where 8 of 64 experts
are held), it would hold 8x the 6 x 8 / 64 = 0.75 rows a token fills on
average. A layer whose pairs all go to experts held elsewhere (a
collapsed router can send every token to the same k) has an empty
buffer: the grouped GEMMs return without a launch.

The grouped GEMM. ``grouped_gemm(x, w, offs)`` is, for each expert e,
``x[offs[e]:offs[e+1]] . w[e]``, and ``grouped_wgrad(x, dy, offs)`` is each
expert's ``x_e^T . dy_e``; ``GroupedGemm`` is the autograd Function
(backward: dX by ``grouped_gemm`` over the transposed weights, dW by
``grouped_wgrad``; inside the span ``pnt.moe.experts.bwd``). On a CUDA
tensor each launches the kernel in ``csrc/moe_gemm.cu`` (TMA + wgmma,
bf16 operands, fp32 accumulation, tiles walked over the device-side
offsets) or raises; on a CPU tensor it runs the plain version, a loop of
per-expert matmuls (``grouped_gemm_plain``, ``grouped_wgrad_plain``).

M1 replaces no TPU kernel: the JAX package has no expert layer. It was
added because a loop of 8 small matmuls a layer (M ~ 1,870 rows an
expert) pays 8 launches and 8 ragged tails where one persistent launch
walks every expert's tiles.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch import kernels
from pacednegatives_tpu_torch.utils.profiling import host_sync, span

BLOCK = 128  # rows: every expert's segment starts at a multiple


def route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          top_k: int, scaling: float, norm_topk: bool):
    """The sigmoid router (DeepSeek-V3's ``noaux_tc`` with one group):
    fp32 logits x . weight over every expert, scores = sigmoid(logits);
    the top k of scores + ``bias`` (the correction bias, for the choice
    only); weights = the chosen scores, normalised to sum 1 with
    ``norm_topk``, times ``scaling``. Returns (weights (T, k) fp32, expert
    ids (T, k) int64), ids in descending order of biased score."""
    scores = torch.sigmoid(x.float() @ weight.float())
    idx = torch.topk(scores.detach() + bias.float(), top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm_topk and top_k > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scaling, idx


def dispatch_plan(idx: torch.Tensor, first: int, held: int) -> dict:
    """Where each (token, slot) pair routed to a held expert goes, all on
    the device but for the buffer's size, read back once (``moe.sizes``).
    ``idx`` (T, k): the router's expert ids.

    Returns ``offs`` (held + 1,) int32, the segments' starts (each a
    multiple of BLOCK) and the end of the last; ``rows``, that end as an
    int: the buffer's rows; ``counts`` (held,) the pairs of each expert;
    ``pair_row`` (T, k), each pair's row, or ``rows`` (a zero row past the
    buffer) for a pair on an expert not held; ``row_pair`` (rows,), each
    row's flat pair index t * k + j, or T * k for a padding row."""
    T, k = idx.shape
    dev = idx.device
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    counts = counts[:held]
    padded = (counts + BLOCK - 1) // BLOCK * BLOCK
    zero = counts.new_zeros(1)
    offs = torch.cat([zero, padded.cumsum(0)])
    with host_sync("moe.sizes"):
        rows = int(offs[-1])
    starts = torch.cat([zero, counts.cumsum(0)])
    sk = key[order]
    inside = sk < held
    e = torch.where(inside, sk, 0)
    dest = torch.where(inside, offs[e] + torch.arange(T * k, device=dev)
                       - starts[e], rows)
    pair_row = torch.empty(T * k, dtype=torch.int64, device=dev)
    pair_row[order] = dest
    row_pair = torch.full((rows + 1,), T * k, dtype=torch.int64, device=dev)
    row_pair[dest] = torch.where(inside, order, T * k)
    return {"offs": offs.to(torch.int32), "counts": counts,
            "pair_row": pair_row.view(T, k), "row_pair": row_pair[:rows],
            "rows": rows}


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class _Dispatch(torch.autograd.Function):
    """(T, D) tokens -> (rows, D) expert buffer: row r holds the token of
    its pair, zeros for padding. Backward: each token's rows summed in
    fp32, in slot order (a gather, no atomics)."""

    @staticmethod
    def forward(ctx, x, row_token, pair_row):
        ctx.save_for_backward(pair_row)
        return _with_zero_row(x)[row_token]

    @staticmethod
    def backward(ctx, g):
        (pair_row,) = ctx.saved_tensors
        with span("pnt.moe.dispatch"):
            ge = _with_zero_row(g)
            acc = ge[pair_row[:, 0]].float()
            for j in range(1, pair_row.shape[1]):
                acc += ge[pair_row[:, j]].float()
            return acc.to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """(rows, D) expert outputs and (T, k) routing weights -> (T, D): each
    token's sum over its held pairs of weight x output, in fp32, rounded
    once. Backward: each row's output gradient is its token's times its
    pair's weight; each weight's is the dot of its row's output with its
    token's gradient (0 for a pair not held)."""

    @staticmethod
    def forward(ctx, ys, w, pair_row, row_pair):
        ye = _with_zero_row(ys)
        acc = ye[pair_row[:, 0]].float() * w[:, :1]
        for j in range(1, pair_row.shape[1]):
            acc += ye[pair_row[:, j]].float() * w[:, j:j + 1]
        ctx.save_for_backward(ys, w, pair_row, row_pair)
        return acc.to(ys.dtype)

    @staticmethod
    def backward(ctx, g):
        ys, w, pair_row, row_pair = ctx.saved_tensors
        with span("pnt.moe.combine"):
            T, k = w.shape
            w_row = torch.cat([w.reshape(-1), w.new_zeros(1)])[row_pair]
            g_ext = _with_zero_row(g)
            d_ys = (g_ext[torch.div(row_pair, k, rounding_mode="floor")]
                    .float() * w_row[:, None]).to(ys.dtype)
            ye = _with_zero_row(ys)
            gf = g.float()
            d_w = torch.stack([(ye[pair_row[:, j]].float() * gf).sum(-1)
                               for j in range(k)], dim=1)
            return d_ys, d_w, None, None


def dispatch(x, plan: dict, top_k: int) -> torch.Tensor:
    row_token = torch.div(plan["row_pair"], top_k, rounding_mode="floor")
    return _Dispatch.apply(x, row_token, plan["pair_row"])


def combine(ys, w, plan: dict) -> torch.Tensor:
    return _Combine.apply(ys, w, plan["pair_row"], plan["row_pair"])


# -- the grouped GEMM (M1) ---------------------------------------------------


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       offs: torch.Tensor) -> torch.Tensor:
    """Plain: y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] . w[e] (fp32
    accumulation, x's dtype); rows past the last segment, if any, zero."""
    o = offs.tolist()
    y = x.new_zeros(x.shape[0], w.shape[2])
    for e in range(w.shape[0]):
        if o[e + 1] > o[e]:
            y[o[e]:o[e + 1]] = torch.matmul(x[o[e]:o[e + 1]], w[e])
    return y


def grouped_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                        offs: torch.Tensor) -> torch.Tensor:
    """Plain: dw[e] = x[offs[e]:offs[e+1]]^T . dy[offs[e]:offs[e+1]],
    zeros for an expert with no rows."""
    o = offs.tolist()
    E = len(o) - 1
    dw = x.new_zeros(E, x.shape[1], dy.shape[1])
    for e in range(E):
        if o[e + 1] > o[e]:
            dw[e] = torch.matmul(x[o[e]:o[e + 1]].t(), dy[o[e]:o[e + 1]])
    return dw


def _check(x, w, offs, name):
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous bfloat16 "
                             f"({t.dtype}, strides {t.stride()})")
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned on "
                             f"{x.device}")
    if (offs.dtype != torch.int32 or offs.device != x.device
            or offs.dim() != 1 or not offs.is_contiguous()):
        raise ValueError(f"{name}: offs must be a contiguous 1-D int32 "
                         f"tensor on {x.device}")
    if x.shape[0] % BLOCK:
        raise ValueError(f"{name}: x's rows ({x.shape[0]}) must be a "
                         f"multiple of {BLOCK}")


def _device(t: torch.Tensor) -> int:
    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """(rows, K) x (E, K, N) over offs (E + 1,) -> (rows, N). CPU: the
    plain version. CUDA: the kernel, which takes contiguous bf16, rows a
    multiple of 128, K a multiple of 64 and N of 8, and int32 offsets
    whose segments start at multiples of 128; anything else raises."""
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, offs)
    _check(x, w, offs, "grouped_gemm")
    E, K, N = w.shape
    if x.shape[1] != K or offs.shape[0] != E + 1 or K % 64 or N % 8:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, offs {tuple(offs.shape)}: needs "
                         "K a multiple of 64, N of 8, offs of E + 1")
    y = torch.empty((x.shape[0], N), dtype=torch.bfloat16, device=x.device)
    if x.shape[0] == 0:  # no pair on a held expert
        return y
    rc = kernels.library().pnt_moe_gemm(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), offs.data_ptr(), E,
        x.shape[0], K, N, 0, _device(x),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "moe_gemm")
    grouped_gemm.launches += 1
    return y


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor,
                  offs: torch.Tensor) -> torch.Tensor:
    """(rows, M) and (rows, N) over offs (E + 1,) -> (E, M, N): each
    expert's x_e^T . dy_e. CPU: the plain version. CUDA: the kernel (M a
    multiple of 128, N of 8)."""
    if x.device.type == "cpu":
        return grouped_wgrad_plain(x, dy, offs)
    _check(x, dy, offs, "grouped_wgrad")
    E = offs.shape[0] - 1
    M, N = x.shape[1], dy.shape[1]
    if dy.shape[0] != x.shape[0] or M % BLOCK or N % 8:
        raise ValueError(f"grouped_wgrad: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}: needs equal rows, M a multiple "
                         f"of {BLOCK}, N of 8")
    if x.shape[0] == 0:  # no pair on a held expert
        return torch.zeros((E, M, N), dtype=torch.bfloat16, device=x.device)
    dw = torch.empty((E, M, N), dtype=torch.bfloat16, device=x.device)
    rc = kernels.library().pnt_moe_gemm(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), offs.data_ptr(), E,
        x.shape[0], M, N, 1, _device(x),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "moe_gemm")
    grouped_wgrad.launches += 1
    return dw


grouped_gemm.launches = 0  # kernel launches; the plain CPU route not counted
grouped_wgrad.launches = 0


class GroupedGemm(torch.autograd.Function):
    """``grouped_gemm`` with its backward: dX = the grouped GEMM of dY
    over the transposed weights, dW = ``grouped_wgrad``, both under the
    span ``pnt.moe.experts.bwd`` on the thread that runs the backward."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return grouped_gemm(x, w, offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        with span("pnt.moe.experts.bwd"):
            if ctx.needs_input_grad[0]:
                dx = grouped_gemm(dy, w.transpose(1, 2).contiguous(), offs)
            if ctx.needs_input_grad[1]:
                dw = grouped_wgrad(x, dy, offs)
        return dx, dw, None


def experts(xs: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
            offs: torch.Tensor) -> torch.Tensor:
    """The held experts' SwiGLU over the dispatch buffer: (rows, D) x
    (E, D, 2F) -> silu(gate) * up -> x (E, F, D) -> (rows, D)."""
    gu = GroupedGemm.apply(xs, gate_up, offs)
    F = gu.shape[1] // 2
    h = torch.nn.functional.silu(gu[:, :F]) * gu[:, F:]
    return GroupedGemm.apply(h.contiguous(), down, offs)
