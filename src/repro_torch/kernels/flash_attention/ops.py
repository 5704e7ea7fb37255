"""Entry points of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the kernel of ``csrc/flash_attention.cu`` (or the wrapper raises), a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
the card to the plain version.  The checks below hold on both devices,
but for the head dims (q's and k's Dk, v's and the output's Dv): the plain
version takes any (Dk, Dv); on the card
  * the forward kernel takes the pairs of ``FWD_HEAD_DIMS``: (32, 32),
    (64, 64), (128, 128), (256, 256) and MLA's (192, 128)
    (``check_forward_dims``); ``forward_plan`` names the kernel a
    (dtype, pair) launches: the bfloat16 forward on ``wgmma`` at (192, 128),
    the ``mma.sync`` one everywhere else;
  * the backward kernels take the same pairs in float32, and the square
    ones up to 128 in bfloat16 (``BWD_HEAD_DIMS``,
    ``check_backward_dims``);
  * the tangent kernels take ``HEAD_DIMS`` with Dk == Dv, float32 only
    (``check_tangent_dims``): FLECS-CGD with m > 0 at the other pairs
    comes with ROADMAP.md's 'family HVPs'.

Queries sit at key positions 0..S-1, so Sq must equal Sk: the Pallas
kernel's docstring says queries align to the end of the KV sequence, but
its code aligns them to the start, and the two agree only when Sq == Sk,
the only case prefill uses.  Any S >= 1 is taken (the kernel masks the
ragged last tile; the Pallas wrapper asserts S % 128 == 0).

Gradients: where an operand requires grad (the training path) or is a
forward-AD dual (a Hessian-vector product, ``core/hessian.py``), the call
goes through ``FlashAttention``, a ``torch.autograd.Function`` whose forward
launches the kernel with its log-sum-exp output, whose ``jvp`` launches the
forward-tangent kernel (tO and t_lse), and whose backward goes through
``FlashAttentionBackward``: its forward launches the backward kernels (dQ,
dK, dV), its ``jvp`` the backward-tangent kernels (the tangents of dQ, dK
and dV).  So forward-over-reverse (a ``jvp`` of the gradient) runs on the
card through kernels alone.  Otherwise the forward kernel runs alone, as
the serving path calls it.  On the CPU the plain version runs under
autograd (and forward AD), and is the counterpart the card's kernels are
held to.  The tangent kernels (``csrc/flash_attention_jvp.cu``) take
float32 only; a bfloat16 dual raises.  A dual tensor that reaches a raw
launch raises (``kernels/dual.py``): no tangent is ever dropped.

Every forward launch adds one to ``launches["flash_attention"]`` (and to
its kernel's count in ``forward_launches_by_kernel``), every
backward one to ``launches["flash_attention_backward"]`` (and to its pair's
count in ``backward_launches_by_pair``), and the tangent
kernels to ``launches["flash_attention_jvp"]`` and
``launches["flash_attention_backward_jvp"]``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.autograd.forward_ad as fwAD

from repro_torch.kernels.dual import refuse_duals, tangent
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.build import JVP_LIBRARY, LIBRARY

#: (Dk, Dv) head-dim pairs the forward kernel is built for: q's and k's
#: head dim, v's and the output's.  The plain version takes any pair.
FWD_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
#: (Dk, Dv) pairs the backward kernels are built for, by dtype.
BWD_HEAD_DIMS = {torch.float32: FWD_HEAD_DIMS,
                 torch.bfloat16: ((32, 32), (64, 64), (128, 128))}
#: (Dk, Dv) pairs the bfloat16 forward on ``wgmma`` is built for: MLA's
#: (192, 128), which ``forward_plan`` routes to it, and the square pairs it
#: is timed at beside the ``mma.sync`` kernel (``kernel_timing.py
#: flash-families``).
WGMMA_FWD_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))
#: The forward kernels, as the C entry numbers them.
FWD_KERNELS = {"mma_sync": 0, "wgmma": 1}
#: Head dims the tangent kernels are built for (Dk == Dv).
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last :func:`reset_launches`.
launches = {"flash_attention": 0, "flash_attention_backward": 0,
            "flash_attention_jvp": 0, "flash_attention_backward_jvp": 0}
#: The backward's launches since the last :func:`reset_launches` by (Dk,
#: Dv) pair (their sum is ``launches["flash_attention_backward"]``).
backward_launches_by_pair = {}
#: The forward's launches since the last :func:`reset_launches` by kernel
#: (their sum is ``launches["flash_attention"]``).
forward_launches_by_kernel = {name: 0 for name in FWD_KERNELS}

#: Where tangents in bfloat16 come from (ROADMAP.md).
_LATER_BF16_TANGENTS = "ROADMAP.md queue 1, 'bf16 attention tangents'"
#: Where the tangent kernels at the forward's other head dims come from
#: (ROADMAP.md).
_LATER_FAMILY_HVPS = "ROADMAP.md queue 1, 'family HVPs'"
#: Where the bfloat16 backward at (256, 256) and (192, 128) comes from.
_LATER_BF16_FAMILY_BACKWARD = ("ROADMAP.md queue 1, 'bf16 family "
                               "backward'")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for name in forward_launches_by_kernel:
        forward_launches_by_kernel[name] = 0
    backward_launches_by_pair.clear()


def forward_plan(dtype, dk: int, dv: int) -> str:
    """The forward kernel a CUDA call of ``dtype`` at head dims (dk, dv)
    launches: "wgmma" (``wgf::fwd_kernel``) for bfloat16 at MLA's (192,
    128), where the ``mma.sync`` kernel lost most to SDPA; "mma_sync"
    (``flash_fwd_kernel``) for every other pair and for float32."""
    if dtype == torch.bfloat16 and (dk, dv) == (192, 128):
        return "wgmma"
    return "mma_sync"


def check_forward_dims(dk: int, dv: int) -> None:
    """Raise unless the forward kernel is built for q/k head dim ``dk`` and
    v head dim ``dv`` (``FWD_HEAD_DIMS``); CUDA operands only."""
    if (dk, dv) not in FWD_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims ({dk}, {dv}) not "
                         f"built for the card (the forward is built for "
                         f"(Dk, Dv) in {FWD_HEAD_DIMS})")


def check_backward_dims(dk: int, dv: int, dtype=torch.float32) -> None:
    """Raise unless the backward kernels are built for these head dims in
    ``dtype`` (``BWD_HEAD_DIMS``); CUDA operands only: on the CPU the plain
    version serves every dim."""
    if (dk, dv) in BWD_HEAD_DIMS.get(dtype, ()):
        return
    if dtype == torch.bfloat16 and (dk, dv) in FWD_HEAD_DIMS:
        raise ValueError(f"flash_attention: the bfloat16 backward is built "
                         f"for {BWD_HEAD_DIMS[dtype]}, got ({dk}, {dv}) "
                         f"(float32 takes it); it comes with "
                         f"{_LATER_BF16_FAMILY_BACKWARD}")
    raise ValueError(f"flash_attention: the backward kernels are built for "
                     f"head dims (Dk, Dv) in {FWD_HEAD_DIMS}, got "
                     f"({dk}, {dv})")


def check_tangent_dims(dk: int, dv: int) -> None:
    """Raise unless the tangent kernels are built for these head dims
    (``HEAD_DIMS``, Dk == Dv); CUDA operands only."""
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the tangent kernels are built "
                         f"for head dims {HEAD_DIMS} with Dk == Dv, got "
                         f"({dk}, {dv}); the others come with "
                         f"{_LATER_FAMILY_HVPS}")


def _check(q, k, v, window, cap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q [B, H, S, Dk], k [B, KV, S, "
                         f"Dk] and v [B, KV, S, Dv] required, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, KV, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of KV)")
    if Sq != Sk:
        raise ValueError(f"flash_attention: Sq == Sk required (queries sit "
                         f"at key positions 0..S-1), got {Sq} and {Sk}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 operands of "
                        f"one type required, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: operands on different devices")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if window < 0 or cap < 0:
        raise ValueError(f"flash_attention: window >= 0 and cap >= 0 "
                         f"required, got {window}, {cap}")
    if q.device.type == "cuda":
        check_forward_dims(D, v.shape[-1])


def _strides(*tensors):
    """Batch, head and sequence strides of [B, H, S, D] views whose head
    dimension is contiguous, as the kernels' int64 array."""
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("flash_attention: the head dimension must be "
                             "contiguous")
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _rows_aligned(t):
    """t if each of its [B, H, S] rows starts on 16 bytes (the forward
    stages q, k and v, the backward also dout, the tangent kernels also the
    tangents of q, k, v and dout, with 16-byte asynchronous copies), else a
    contiguous copy, whose rows do.  A view whose head dimension is strided
    is returned as it is, for ``_strides`` to reject."""
    size = t.element_size()
    if t.stride(-1) != 1:
        return t
    if t.data_ptr() % 16 == 0 and all(
            t.stride(i) * size % 16 == 0 for i in range(3) if t.shape[i] > 1):
        return t
    return t.contiguous()


def _launch(q, k, v, out, window, cap, lse=None, kernel=None) -> None:
    """The forward kernel on [B, H, S, D] views of any batch/head/sequence
    strides (v and ``out`` of head dim Dv); writes ``out`` (q's type) and,
    if given, ``lse`` (float32 [B, H, S], contiguous).  ``kernel``: the
    ``FWD_KERNELS`` name to launch, by default ``forward_plan``'s; the
    ``wgmma`` one takes bfloat16 at ``WGMMA_FWD_HEAD_DIMS``."""
    refuse_duals("flash_attention", q, k, v, out, lse)
    B, H, S, D = q.shape
    kernel = kernel or forward_plan(q.dtype, D, v.shape[-1])
    if kernel == "wgmma" and (q.dtype != torch.bfloat16 or (
            D, v.shape[-1]) not in WGMMA_FWD_HEAD_DIMS):
        raise ValueError(f"flash_attention: the wgmma forward takes "
                         f"bfloat16 at {WGMMA_FWD_HEAD_DIMS}, got {q.dtype} "
                         f"({D}, {v.shape[-1]})")
    q, k, v = map(_rows_aligned, (q, k, v))
    strides = _strides(q, k, v, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.load().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], B, H,
            k.shape[1], S, D, v.shape[-1], int(window), float(cap),
            FWD_KERNELS[kernel], ctypes.addressof(strides), stream)
    LIBRARY.check("flash_attention", rc)
    launches["flash_attention"] += 1
    forward_launches_by_kernel[kernel] += 1


def _launch_backward(q, k, v, out, dout, lse, dq, dk, dv, window,
                     cap) -> None:
    """The backward kernels on [B, H, S, D] views (k, v, dk, dv with KV
    heads; v, out, dout and dv of head dim Dv): write dq, dk and dv from
    the forward's out and lse."""
    refuse_duals("flash_attention_backward", q, k, v, out, dout, lse, dq, dk,
                 dv)
    check_backward_dims(q.shape[-1], v.shape[-1], q.dtype)
    q, k, v, dout = map(_rows_aligned, (q, k, v, dout))
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    B, H, S, D = q.shape
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.load().repro_flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, H, k.shape[1],
            S, D, v.shape[-1], int(window), float(cap),
            ctypes.addressof(strides), stream)
    LIBRARY.check("flash_attention_backward", rc)
    launches["flash_attention_backward"] += 1
    pair = (D, v.shape[-1])
    backward_launches_by_pair[pair] = backward_launches_by_pair.get(pair,
                                                                    0) + 1


def _launch_jvp(q, k, v, out, lse, tq, tk, tv, tout, tlse, window,
                cap) -> None:
    """The forward-tangent kernel on float32 [B, H, S, D] views (k, v and
    their tangents with KV heads): writes tout and tlse (float32 [B, H, S],
    contiguous) from the forward's output ``out`` and its lse."""
    refuse_duals("flash_attention_jvp", q, k, v, out, lse, tq, tk, tv, tout,
                 tlse)
    check_tangent_dims(q.shape[-1], v.shape[-1])
    q, k, v, tq, tk, tv = map(_rows_aligned, (q, k, v, tq, tk, tv))
    strides = _strides(q, k, v, out, tq, tk, tv, tout)
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = JVP_LIBRARY.load().repro_flash_attention_jvp(
            *(t.data_ptr() for t in (q, k, v, out, lse, tq, tk, tv, tout,
                                     tlse)),
            B, H, k.shape[1], S, D, int(window), float(cap),
            ctypes.addressof(strides), stream)
    JVP_LIBRARY.check("flash_attention_jvp", rc)
    launches["flash_attention_jvp"] += 1


def _launch_backward_jvp(q, k, v, out, dout, lse, tq, tk, tv, tout, tdout,
                         tlse, tdq, tdk, tdv, window, cap) -> None:
    """The backward-tangent kernels on float32 [B, H, S, D] views (k, v,
    their tangents and tdk, tdv with KV heads): write the tangents of dq,
    dk and dv from the forward's out and lse and their tangents."""
    refuse_duals("flash_attention_backward_jvp", q, k, v, out, dout, lse,
                 tq, tk, tv, tout, tdout, tlse, tdq, tdk, tdv)
    check_tangent_dims(q.shape[-1], v.shape[-1])
    q, k, v, dout, tq, tk, tv, tdout = map(
        _rows_aligned, (q, k, v, dout, tq, tk, tv, tdout))
    strides = _strides(q, k, v, out, dout, tq, tk, tv, tout, tdout, tdq,
                       tdk, tdv)
    B, H, S, D = q.shape
    delta, tdelta = (torch.empty((B, H, S), dtype=torch.float32,
                                 device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = JVP_LIBRARY.load().repro_flash_attention_backward_jvp(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, tq, tk, tv,
                                     tout, tdout, tlse, delta, tdelta, tdq,
                                     tdk, tdv)),
            B, H, k.shape[1], S, D, int(window), float(cap),
            ctypes.addressof(strides), stream)
    JVP_LIBRARY.check("flash_attention_backward_jvp", rc)
    launches["flash_attention_backward_jvp"] += 1


def _kernel_layout(t, model_layout: bool):
    return t.transpose(1, 2) if model_layout else t


def _primal(t):
    return fwAD.unpack_dual(t).primal


def _float32_tangents(*tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"flash_attention: the tangent kernels take float32 "
                        f"only, got {tensors[0].dtype}; bfloat16 tangents "
                        f"come with {_LATER_BF16_TANGENTS}")


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


class FlashAttention(torch.autograd.Function):
    """The kernel with a backward and a forward tangent: ``apply(q, k, v,
    window, cap, model_layout)``, operands in the model layout [B, S, H, D]
    or, with ``model_layout`` False, the kernel layout [B, H, S, D].  Saves
    q, k, v, the output and the float32 log-sum-exp; ``jvp`` keeps the
    tangents tO and t_lse on ``ctx`` for the backward's own tangent.  CUDA
    tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, window, cap, model_layout):
        given = (q, k, v)
        q, k, v = map(_primal, given)
        out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                          device=q.device)
        qt = _kernel_layout(q, model_layout)
        lse = torch.empty(qt.shape[:3], dtype=torch.float32, device=q.device)
        _launch(qt, *(_kernel_layout(t, model_layout) for t in (k, v, out)),
                window, cap, lse)
        # q, k, v saved as given: where they are duals, the backward sees
        # their tangents (the kernels get the primals)
        ctx.save_for_backward(*given, out, lse)
        ctx.save_for_forward(q, k, v, out, lse)
        ctx.window, ctx.cap, ctx.model_layout = window, cap, model_layout
        ctx.tangents = None
        return out

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        q, k, v, out, lse = map(_primal, ctx.saved_tensors)
        _float32_tangents(q, k, v)
        tq, tk, tv = (_zeros_if_none(t, x).contiguous()
                      for t, x in ((tq, q), (tk, k), (tv, v)))
        tout = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        tlse = torch.empty_like(lse)
        views = [_kernel_layout(t, ctx.model_layout)
                 for t in (q, k, v, out, tq, tk, tv, tout)]
        _launch_jvp(*views[:4], lse, *views[4:], tlse, ctx.window, ctx.cap)
        ctx.tangents = (tout, tlse)
        return tout

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.tangents is not None and any(tangent(t) is not None
                                            for t in (q, k, v)):
            # forward-over-reverse: out and lse carry the tangents the jvp
            # computed, whether or not grad_out carries one (a loss linear
            # in the output through a constant gives a grad_out without)
            out = fwAD.make_dual(_primal(out), ctx.tangents[0])
            lse = fwAD.make_dual(_primal(lse), ctx.tangents[1])
        dq, dk, dv = FlashAttentionBackward.apply(
            q, k, v, out, grad_out, lse, ctx.window, ctx.cap,
            ctx.model_layout)
        return dq, dk, dv, None, None, None


class FlashAttentionBackward(torch.autograd.Function):
    """The backward kernels as a differentiable function: ``apply(q, k, v,
    out, dout, lse, window, cap, model_layout) -> (dq, dk, dv)``; its
    ``jvp`` launches the backward-tangent kernels.  It has no backward: a
    second reverse pass is not a path of this repository (Hessian-vector
    products run forward over reverse)."""

    @staticmethod
    def forward(ctx, q, k, v, out, dout, lse, window, cap, model_layout):
        q, k, v, out, dout, lse = map(_primal, (q, k, v, out, dout, lse))
        dout = dout.to(q.dtype)
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        views = [_kernel_layout(t, model_layout)
                 for t in (q, k, v, out, dout, dq, dk, dv)]
        _launch_backward(*views[:5], lse, *views[5:], window, cap)
        ctx.save_for_forward(q, k, v, out, dout, lse)
        ctx.window, ctx.cap, ctx.model_layout = window, cap, model_layout
        return dq, dk, dv

    @staticmethod
    def jvp(ctx, tq, tk, tv, tout, tdout, tlse, *_):
        q, k, v, out, dout, lse = ctx.saved_tensors
        _float32_tangents(q, k, v, out, dout)
        tq, tk, tv, tout, tdout, tlse = (
            _zeros_if_none(t, x).contiguous() for t, x in (
                (tq, q), (tk, k), (tv, v), (tout, out), (tdout, dout),
                (tlse, lse)))
        tdq, tdk, tdv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in (q, k, v))
        views = [_kernel_layout(t, ctx.model_layout) for t in (
            q, k, v, out, dout, tq, tk, tv, tout, tdout, tdq, tdk, tdv)]
        _launch_backward_jvp(*views[:5], lse, *views[5:10], tlse,
                             *views[10:], ctx.window, ctx.cap)
        return tdq, tdk, tdv


def _check_training(q, k, v) -> None:
    """The head-dim checks of a call with gradients or tangents, before its
    forward launches: the backward's pair in q's dtype, and where an
    operand is a forward-AD dual, the tangent kernels' head dims."""
    dk, dv = q.shape[-1], v.shape[-1]
    check_backward_dims(dk, dv, q.dtype)
    if any(tangent(t) is not None for t in (q, k, v)):
        check_tangent_dims(dk, dv)


def _needs_grad(*tensors) -> bool:
    return ((torch.is_grad_enabled() and any(t.requires_grad
                                             for t in tensors))
            or any(tangent(t) is not None for t in tensors))


def flash_attention(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, H, S, Dk]; k: [B, KV, S, Dk]; v: [B, KV, S, Dv] (kernel
    layout).  Causal GQA attention with an optional sliding window and tanh
    soft-cap, scaled by 1/sqrt(Dk); float32 arithmetic, result
    [B, H, S, Dv] in q's type.  On the card (Dk, Dv) is one of
    ``FWD_HEAD_DIMS``, with gradients one of ``BWD_HEAD_DIMS`` and with
    tangents one of ``HEAD_DIMS``."""
    _check(q, k, v, window, cap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, window, cap)
    if _needs_grad(q, k, v):
        _check_training(q, k, v)
        return FlashAttention.apply(q, k, v, window, cap, False)
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    _launch(q, k, v, out, window, cap)
    return out


def attention(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, S, H, Dk]; k: [B, S, KV, Dk]; v: [B, S, KV, Dv] (model
    layout).  The kernel reads and writes the model layout in place through
    strides: no transposed copy is made on the card."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _check(qt, kt, vt, window, cap)
    if q.device.type == "cpu":
        return ref.attention_ref(qt, kt, vt, window, cap).transpose(1, 2)
    if _needs_grad(q, k, v):
        _check_training(q, k, v)
        return FlashAttention.apply(q, k, v, window, cap, True)
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    _launch(qt, kt, vt, out.transpose(1, 2), window, cap)
    return out
