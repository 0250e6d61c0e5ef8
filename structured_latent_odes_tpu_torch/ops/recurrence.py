"""Kernels K1 and K1-bwd: the affine scan ``x_t = A_t * x_{t-1} + B_t`` and
its reverse (adjoint) sweep.

K1 replaces the Pallas TPU kernel ``structured_latent_odes_tpu/ops/recurrence.py
::_scan_kernel`` (launched by ``_affine_scan_raw``; entry points
``affine_scan_pallas_tm`` and ``affine_scan_pallas``); K1-bwd replaces the
same kernel as the JAX package's custom VJP ``_bwd`` runs it on time-reversed
coefficients. Both are in ``csrc/affine_scan.cu`` and take the batch-major
layout the model holds: coefficients ``(Bt, T, D)``, trajectories
``(Bt, T+1, D)``. A block owns four whole trajectories, whose runs in every
array are contiguous: one thread copies each input run into shared memory
with one bulk copy of the Tensor Memory Accelerator, a thread per component
runs the chain from there, and all threads store the output runs with
16-byte stores. At the training shape a launch is bound by latency, at large
batch by bytes (each array read or written once). A block's shared memory
caps the steps: at D = 5, T up to 966 forward and 579 backward (CVS and proc
have 85 steps, challenge 141). The wrappers ask the library for the cap
(``affine_scan_max_steps``) and raise above it; the model's entry splits the
work instead (below).

:func:`affine_scan` (batch-major, the model's entry) and
:func:`affine_scan_tm` (time-major) are differentiable: a
``torch.autograd.Function`` runs K1 forward (saving A and the trajectory) and
K1-bwd backward, and hands both the tensors it holds, with no copy; where no
gradient is asked for, :func:`affine_scan` calls K1's wrapper directly. Under
``torch.func.vmap`` (the ensemble's member axis, ``train/ensemble.py``) the
function folds the member axis into ``Bt`` as a view and launches once for
all members.

Above the cap the model's entry splits the work (:func:`scan_in_runs`,
:func:`scan_bwd_in_runs`): the time axis into runs of at most the cap, each
run's inputs copied into contiguous buffers, the last state of a run the next
run's ``x0`` forward and, backward, the ``dx0`` of a later run in place of the
earlier run's last cotangent row; and a width above 32 into slices of at most
32 components, which are independent recurrences. The operations are the
plain versions' in their order, so the split result is bit-equal to them.
Shapes within the cap stay one launch, with no copy.

:func:`affine_scan_fwd` and :func:`affine_scan_bwd` are the kernels'
wrappers, one launch each, raising above the cap;
:func:`affine_scan_batched_plain` and :func:`affine_scan_bwd_batched_plain`
their plain PyTorch versions, used for a tensor on the CPU and held against
the kernels on the card; :func:`affine_scan_plain` computes the forward
time-major, ``(T, ...)``, as a batch of one. A wrapper takes contiguous
float32 tensors on one device and raises on anything else; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from structured_latent_odes_tpu_torch.ops import _build

Tensor = torch.Tensor

# (A, B, x0, out, Bt, T, D, stream) and (A, xs, g, dA, dB, dx0, Bt, T, D, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def affine_scan_batched_plain(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Plain version of K1, the scan over time axis 1: A, B ``(Bt, T, ...)``,
    x0 ``(Bt, ...)`` -> ``(Bt, T+1, ...)`` including x0. The product and the
    sum round separately."""
    xs = [x0]
    x = x0
    for t in range(A.shape[1]):
        x = A[:, t] * x + B[:, t]
        xs.append(x)
    return torch.stack(xs, 1)


def affine_scan_bwd_batched_plain(A: Tensor, xs: Tensor, g: Tensor):
    """Plain version of K1-bwd, the reverse sweep of
    :func:`affine_scan_batched_plain`: A ``(Bt, T, ...)``, the trajectory xs
    and its cotangent g ``(Bt, T+1, ...)`` -> (dA, dB ``(Bt, T, ...)``, dx0
    ``(Bt, ...)``)."""
    lam = g[:, -1]
    dA, dB = [], []
    for t in range(A.shape[1] - 1, -1, -1):
        dA.append(lam * xs[:, t])
        dB.append(lam)
        lam = A[:, t] * lam + g[:, t]
    return torch.stack(dA[::-1], 1), torch.stack(dB[::-1], 1), lam


def affine_scan_plain(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """The scan over time axis 0: A, B ``(T, ...)``, x0 ``(...)`` ->
    ``(T+1, ...)`` including x0; :func:`affine_scan_batched_plain` on a batch
    of one."""
    return affine_scan_batched_plain(A[None], B[None], x0[None])[0]


def _check(name: str, tensors, shapes) -> None:
    """Shapes as given; float32, contiguous and on one device: a wrapper
    neither copies nor converts."""
    if any(t.shape != shape for t, shape in zip(tensors, shapes)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}, expected {list(shapes)}")
    device = tensors[0].device
    if any(t.device != device or t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous float32 tensors on one device")


@functools.lru_cache(maxsize=None)
def _max_steps(D: int, backward: bool) -> int:
    """The most steps a launch takes at width D (csrc/affine_scan.cu
    ``affine_scan_max_steps``: a tile's runs in one block's shared memory); -1
    for a width the kernels do not take."""
    fn = _build.function("affine_scan", "affine_scan_max_steps", [ctypes.c_int, ctypes.c_int])
    return fn(D, int(backward))


def _cuda_only(name: str, device: torch.device, T: int, D: int, backward: bool) -> None:
    """What only the kernel limits: the device, D and the steps a block's
    shared memory holds."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if D == 0:
        return
    steps = _max_steps(D, backward)
    if steps < 0:
        raise ValueError(f"{name} runs a thread per component: D = {D} is wider than the kernel takes")
    if T > steps:
        raise ValueError(f"{name}: a tile of trajectories of {T} steps needs more shared memory than a "
                         f"block has (at most {steps} steps at D = {D})")


def _coeff_shape(name: str, A: Tensor):
    if A.ndim != 3:
        raise ValueError(f"{name}: shapes: A {tuple(A.shape)} is not (Bt, T, D)")
    return A.shape


def affine_scan_fwd(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """K1's wrapper: A, B ``(Bt, T, D)``, x0 ``(Bt, D)`` -> ``(Bt, T+1, D)``,
    x0 in step 0."""
    Bt, T, D = _coeff_shape("affine_scan_fwd", A)
    _check("affine_scan_fwd", (A, B, x0), ((Bt, T, D), (Bt, T, D), (Bt, D)))
    if A.device.type == "cpu":
        return affine_scan_batched_plain(A, B, x0)
    _cuda_only("affine_scan_fwd", A.device, T, D, backward=False)
    out = A.new_empty((Bt, T + 1, D))
    if Bt and D:
        fn = _build.function("affine_scan", "affine_scan_fwd", _FWD_ARGTYPES)
        _build.launch("affine_scan_fwd", fn, A, B, x0, out, Bt, T, D)
        affine_scan_fwd.launches += 1
    return out


affine_scan_fwd.launches = 0


def affine_scan_bwd(A: Tensor, xs: Tensor, g: Tensor):
    """K1-bwd's wrapper: A ``(Bt, T, D)``, the trajectory xs and its
    cotangent g ``(Bt, T+1, D)`` -> (dA ``(Bt, T, D)``, dB ``(Bt, T, D)``,
    dx0 ``(Bt, D)``)."""
    Bt, T, D = _coeff_shape("affine_scan_bwd", A)
    _check("affine_scan_bwd", (A, xs, g), ((Bt, T, D), (Bt, T + 1, D), (Bt, T + 1, D)))
    if A.device.type == "cpu":
        return affine_scan_bwd_batched_plain(A, xs, g)
    _cuda_only("affine_scan_bwd", A.device, T, D, backward=True)
    dA = torch.empty_like(A)
    dB = torch.empty_like(A)
    dx0 = A.new_empty((Bt, D))
    if Bt and D:
        fn = _build.function("affine_scan", "affine_scan_bwd", _BWD_ARGTYPES)
        _build.launch("affine_scan_bwd", fn, A, xs, g, dA, dB, dx0, Bt, T, D)
        affine_scan_bwd.launches += 1
    return dA, dB, dx0


affine_scan_bwd.launches = 0


# a thread per component of a four-trajectory tile (csrc/affine_scan.cu kMaxD)
_MAX_D = 32


def _components(D: int, width: int):
    return [(d0, min(d0 + width, D)) for d0 in range(0, D, width)]


def scan_in_runs(launch, A: Tensor, B: Tensor, x0: Tensor, cap: int, width: int) -> Tensor:
    """The forward scan of A, B ``(Bt, T, D)`` and x0 ``(Bt, D)`` as
    launches of ``launch`` (K1's wrapper, or its plain version) on runs of at
    most ``cap`` steps and ``width`` components, each run's inputs copied into
    contiguous buffers. A run starts from the previous run's last state, and
    its rows after the first go to the output: the seam row is written once.
    Returns the contiguous ``(Bt, T+1, D)`` trajectory."""
    Bt, T, D = A.shape
    out = A.new_empty((Bt, T + 1, D))
    out[:, 0] = x0
    for d0, d1 in _components(D, width):
        x = x0[:, d0:d1].contiguous()
        for t0 in range(0, T, cap):
            t1 = min(t0 + cap, T)
            xs = launch(A[:, t0:t1, d0:d1].contiguous(), B[:, t0:t1, d0:d1].contiguous(), x)
            out[:, t0 + 1:t1 + 1, d0:d1] = xs[:, 1:]
            x = xs[:, -1].contiguous()
    return out


def scan_bwd_in_runs(launch, A: Tensor, xs: Tensor, g: Tensor, cap: int, width: int):
    """The reverse sweep of :func:`scan_in_runs` with ``launch`` (K1-bwd's
    wrapper, or its plain version): runs last to first. A later run covers
    steps t0..t1-1 with cotangent rows t0..t1 and returns as its dx0 the
    adjoint at t0, ``A[t0] * lam + g[t0]``; the earlier run takes that value in
    place of its last cotangent row (``g[t0]`` is already in it), so the
    operations and their order are those of the unsplit sweep. Returns (dA,
    dB ``(Bt, T, D)``, dx0 ``(Bt, D)``)."""
    Bt, T, D = A.shape
    dA, dB = torch.empty_like(A), torch.empty_like(A)
    dx0 = A.new_empty((Bt, D))
    starts = list(range(0, T, cap))
    for d0, d1 in _components(D, width):
        lam = None
        for t0 in reversed(starts):
            t1 = min(t0 + cap, T)
            # a copy even where the slice is contiguous already (Bt = 1):
            # the seam row written below must not reach the caller's g
            g_run = g[:, t0:t1 + 1, d0:d1].clone(memory_format=torch.contiguous_format)
            if lam is not None:
                g_run[:, -1] = lam
            da, db, lam = launch(A[:, t0:t1, d0:d1].contiguous(), xs[:, t0:t1 + 1, d0:d1].contiguous(), g_run)
            dA[:, t0:t1, d0:d1] = da
            dB[:, t0:t1, d0:d1] = db
        dx0[:, d0:d1] = lam
    return dA, dB, dx0


def _split(A: Tensor, backward: bool):
    """(cap, width) of the runs K1 (or K1-bwd) takes at A's shape, or None
    where one launch takes it all: on the CPU (the plain version has no cap),
    an empty tensor, or T and D within the kernel's limits."""
    Bt, T, D = A.shape
    if A.device.type != "cuda" or not (Bt and T and D):
        return None
    width = min(D, _MAX_D)
    cap = _max_steps(width, backward)
    if D <= width and T <= cap:
        return None
    return cap, width


def _scan_fwd(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """K1 on the model's shapes: one launch within the cap, else runs."""
    split = _split(A, backward=False)
    if split is None:
        return affine_scan_fwd(A, B, x0)
    return scan_in_runs(affine_scan_fwd, A, B, x0, *split)


def _scan_bwd(A: Tensor, xs: Tensor, g: Tensor):
    """K1-bwd on the model's shapes: one launch within the cap, else runs."""
    split = _split(A, backward=True)
    if split is None:
        return affine_scan_bwd(A, xs, g)
    return scan_bwd_in_runs(affine_scan_bwd, A, xs, g, *split)


def _to_front(t: Tensor, dim, size: int) -> Tensor:
    """A vmapped argument with its member axis first (expanded where the
    argument is shared by all members)."""
    return t.movedim(dim, 0) if dim is not None else t.expand(size, *t.shape)


def _fold(t: Tensor) -> Tensor:
    """(S, Bt, ...) -> (S*Bt, ...): a view of a contiguous tensor."""
    return t.contiguous().reshape(t.shape[0] * t.shape[1], *t.shape[2:])


class _AffineScanBwd(torch.autograd.Function):
    """K1-bwd as a function that ``torch.func.vmap`` can batch (the backward
    of :class:`_AffineScan` runs under the ensemble's vmap)."""

    @staticmethod
    def forward(A, xs, g):
        # the model's cotangent is contiguous already (the heads' matmul
        # makes it), and then contiguous() is no copy
        return _scan_bwd(A, xs, g.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("K1-bwd has no derivative")

    @staticmethod
    def vmap(info, in_dims, A, xs, g):
        S = info.batch_size
        A, xs, g = (_to_front(t, d, S) for t, d in zip((A, xs, g), in_dims))
        dA, dB, dx0 = _scan_bwd(_fold(A), _fold(xs), _fold(g))
        unfold = lambda t: t.reshape(S, -1, *t.shape[1:])  # noqa: E731
        return (unfold(dA), unfold(dB), unfold(dx0)), (0, 0, 0)


class _AffineScan(torch.autograd.Function):
    """K1 forward, K1-bwd backward (the JAX package's ``_fwd``/``_bwd``), on
    batch-major tensors. Under ``torch.func.vmap`` the member axis folds into
    ``Bt``: one launch for all members."""

    @staticmethod
    def forward(A, B, x0):
        return _scan_fwd(A, B, x0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        A, xs = ctx.saved_tensors
        return _AffineScanBwd.apply(A, xs, g)

    @staticmethod
    def vmap(info, in_dims, A, B, x0):
        S = info.batch_size
        A, B, x0 = (_to_front(t, d, S) for t, d in zip((A, B, x0), in_dims))
        xs = _scan_fwd(_fold(A), _fold(B), _fold(x0))
        return xs.reshape(S, -1, *xs.shape[1:]), 0


def _traced(*tensors) -> bool:
    """Whether autograd or a torch.func transform (the ensemble's vmap and
    grad) sees any of the tensors: then the entry goes through the
    ``autograd.Function``."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors) or (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def affine_scan(A: Tensor, B: Tensor, x0: Tensor) -> Tensor:
    """Batch-major entry, as ``affine_scan_pallas``: A, B ``(Bt, T, D)``, x0
    ``(Bt, D)`` -> the contiguous trajectory ``(Bt, T+1, D)`` including x0;
    unbatched ``(T, D)`` and ``(D,)`` too. Differentiable in all three, and
    batched by ``torch.func.vmap``; within the kernels' limits the kernels
    take the tensors as they are, above them the work is split into runs."""
    if A.ndim == 2:
        return affine_scan(A[None], B[None], x0[None])[0]
    if _traced(A, B, x0):
        return _AffineScan.apply(A, B, x0)
    return _scan_fwd(A, B, x0)


def affine_scan_tm(A_tm: Tensor, B_tm: Tensor, x0: Tensor) -> Tensor:
    """Time-major entry: A_tm, B_tm ``(T, M)``, x0 ``(M,)`` -> ``(T+1, M)``;
    differentiable in all three. Each of the M lanes is a trajectory of one
    component, so the kernels get the transposes ``(M, T, 1)``."""
    if A_tm.ndim != 2 or B_tm.shape != A_tm.shape or x0.shape != A_tm.shape[1:]:
        raise ValueError(f"shapes A {tuple(A_tm.shape)}, B {tuple(B_tm.shape)}, x0 {tuple(x0.shape)}")
    xs = affine_scan(A_tm.t().contiguous()[..., None], B_tm.t().contiguous()[..., None], x0[:, None])
    return xs[..., 0].t()
