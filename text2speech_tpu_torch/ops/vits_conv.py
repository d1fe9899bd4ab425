"""VITS's HiFi-GAN generator convolutions, channels-last ([B, T, C]), with
the elementwise work between them done inside each convolution.

It replaces no TPU kernel (VITS has no counterpart in the JAX package).
Each function launches a kernel of ``csrc/vits_conv_sm90.cu`` for CUDA
tensors and takes its plain version (today's ``F.conv1d`` /
``F.conv_transpose1d`` / ``F.leaky_relu`` chain, read channels-last) only
for CPU tensors.  A CUDA tensor the kernel does not take (a dtype other
than bf16, a channel count it has no tile for) raises: nothing falls back.
Each counts its launches in its ``launches`` attribute.

* :func:`conv` -- a same-padded dilated convolution, ``epi(conv(pro(x)) +
  b)``: ``pre`` puts leaky ReLU 0.1 on the input, ``post`` on the output;
  ``res`` and ``acc`` are added after the bias and the sum is scaled by
  ``scale``.  conv_pre, and the two convolutions of a resblock pair.
* :func:`up` -- leaky ReLU 0.1, then the transposed convolution of stride
  u and 2u taps.
* :func:`post` -- leaky ReLU 0.01, conv_post (C -> 1, no bias), tanh:
  f32 audio.

The kernel reads weights packed by :func:`pack` (:func:`pack_post`), once
at load, and on a CUDA tensor each function requires them as ``packed``;
:func:`plan` chooses the tile from the shapes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .build import CudaLibrary
from .wn_block import _on_cpu, _run

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB = CudaLibrary("vits_conv_sm90", {
    "t2s_vits_conv_sm90": [_P] * 6 + [_I] * 11 + [ctypes.c_float]
                          + [_I] * 6 + [_P],
    "t2s_vits_conv_post": [_P, _P, _P, _I, _I, _I, _I, _P],
    "t2s_vits_conv_smem_bytes": [_I] * 6,
})

BF16 = torch.bfloat16
SLOPE = 0.1           # upstream's modules.LRELU_SLOPE
POST_SLOPE = 0.01     # F.leaky_relu's default, before conv_post upstream
NWG = 2               # consumer warpgroups a block
MAX_NA = 2            # window slots
MAX_NW = 16           # weight stages
SMEM_LIMIT = 232448   # a block's shared memory on an H100, bytes
SMEM_SM = 233472      # an SM's
SMEM_BLOCK = 1024     # what the system keeps of it for each block
MAX_BOX_ROWS = 256    # TMA's largest box extent
SMEM_STATIC = 8 * (2 * MAX_NA + 2 * MAX_NW + NWG)   # the kernel's barriers


def _up8(n: int) -> int:
    return -(-n // 8) * 8


# ---------------------------------------------------------------------------
# the kernel's plan and its weight images
# ---------------------------------------------------------------------------


def tile_of(C_out: int) -> tuple:
    """(N, KC): the N tile (all of C_out up to 256) and the K depth of a
    weight stage.  Raises on a C_out the kernel has no tile for."""
    N = min(C_out, 256)
    if N not in (32, 64, 128, 256) or C_out % N:
        raise ValueError(f"vits_conv: {C_out} output channels; the kernel "
                         f"takes 32, 64, 128 or a multiple of 256")
    return N, 32 if N in (32, 256) else 64


# (MT, blocks an SM) to try for an N tile, in order.  N = 128 and 256 take
# 128 accumulator registers a thread and one block an SM; N = 64 and 32
# take 64 and ask for two blocks an SM (csrc/vits_conv_sm90.cu), so that
# one block's prologue and epilogue run beside the other's products, in
# the shared memory of two where it fits.  Timed at the cell's shapes
# (PERF.md): the best or within ~10% of it at every (k, d) of a stage.
TILES = {256: ((1, 1),), 128: ((2, 1), (1, 1)), 64: ((2, 2), (2, 1)),
         32: ((4, 2), (4, 1))}


@dataclass(frozen=True)
class Plan:
    N: int          # N tile
    MT: int         # 64-row wgmma tiles a warpgroup
    KC: int         # channels a weight stage
    Rb: int         # rows a TMA box
    nb: int         # boxes a window
    NA: int         # window slots
    NW: int         # weight stages in shared memory
    resident: bool  # all stages loaded once a block
    S: int          # weight stages a tile

    @property
    def BM(self) -> int:
        return NWG * 64 * self.MT

    @property
    def EN(self) -> int:
        """Columns of a warpgroup's staging tile."""
        return min(self.N, 128)

    def smem(self, C_in: int) -> int:
        """Dynamic shared memory, as ``t2s_vits_conv_smem_bytes``."""
        return (1024 + self.NA * C_in * self.Rb * self.nb * 2
                + self.NW * self.KC * self.N * 2
                + NWG * 64 * self.MT * self.EN * 2)


def fit(C_in: int, C_out: int, span: int, phase_taps: int, MT: int,
        per_sm: int = 1) -> Plan | None:
    """The tile of MT 64-row wgmma tiles a warpgroup for a convolution
    whose window spans ``span`` rows beyond the block's, with
    ``phase_taps`` (phases x taps) weight matrices, in the shared memory
    of one of ``per_sm`` blocks an SM; None where none fits.  Two window
    slots with every weight stage resident when they fit; else two slots
    and a ring of at least four streamed stages; else one slot, the
    stages resident or streamed."""
    N, KC = tile_of(C_out)
    if C_in % KC:
        raise ValueError(f"vits_conv: {C_in} input channels; the kernel "
                         f"takes multiples of {KC} at {C_out} out")
    rows = _up8(NWG * 64 * MT + span)
    nb = -(-rows // MAX_BOX_ROWS)
    Rb = _up8(-(-rows // nb))
    slot, stage = C_in * Rb * nb * 2, KC * N * 2
    S = phase_taps * (C_in // KC)
    staging = NWG * 64 * MT * min(N, 128) * 2
    budget = (min(SMEM_LIMIT, SMEM_SM // per_sm - SMEM_BLOCK) - SMEM_STATIC
              - 1024 - staging)
    fits = C_out == N and S <= MAX_NW
    for NA in (2, 1):
        if fits and NA * slot + S * stage <= budget:
            return Plan(N, MT, KC, Rb, nb, NA, S, True, S)
        NW = min(MAX_NW, (budget - NA * slot) // stage)
        if NW >= (4 if NA == 2 else 2):
            return Plan(N, MT, KC, Rb, nb, NA, NW, False, S)
    return None


@functools.lru_cache(maxsize=None)
def plan(C_in: int, C_out: int, span: int, phase_taps: int) -> Plan:
    """The kernel's tile for a convolution (:func:`fit`), the first of
    :data:`TILES` that fits (a function of the shapes: kept per shape)."""
    N, _ = tile_of(C_out)
    for MT, per_sm in TILES[N]:
        pl = fit(C_in, C_out, span, phase_taps, MT, per_sm)
        if pl is not None:
            return pl
    raise ValueError(f"vits_conv: no tile fits C_in {C_in}, C_out {C_out}, "
                     f"span {span}")


def tap_weights(w: torch.Tensor, u: int = 0) -> torch.Tensor:
    """[P, taps, C_in, C_out]: each phase's tap matrices in window order.
    A convolution (``u`` 0) has one phase of its k taps (w [C_out, C_in,
    k]); a transposed one (w [C_in, C_out, 2u]) has u, phase p reading
    input rows t - 1, t (p < u - u/2) or t, t + 1."""
    if not u:
        return w.permute(2, 1, 0)[None]
    pad = u // 2
    idx = [(p + pad + u, p + pad) if p < u - pad else (p + pad, p + pad - u)
           for p in range(u)]
    return w.permute(2, 0, 1)[torch.tensor(idx, device=w.device)]


def pack(w: torch.Tensor, u: int = 0) -> torch.Tensor:
    """The kernel's weight stages, bf16 [n_tiles, P, taps, C_in / KC, KC /
    8, N, 8]: each stage the [KC, N] image wgmma reads K-major, in the
    order the kernel consumes them."""
    W = tap_weights(w, u)
    P, taps, C_in, C_out = W.shape
    N, KC = tile_of(C_out)
    if C_in % KC:
        raise ValueError(f"vits_conv: {C_in} input channels; the kernel "
                         f"takes multiples of {KC} at {C_out} out")
    W = W.reshape(P, taps, C_in // KC, KC // 8, 8, C_out // N, N)
    return W.permute(5, 0, 1, 2, 3, 6, 4).to(BF16).contiguous()


def pack_post(w: torch.Tensor) -> torch.Tensor:
    """conv_post's [1, C, k] weight as the FMA kernel reads it: f32 [k, C]."""
    return w[0].t().float().contiguous()


# ---------------------------------------------------------------------------
# plain versions: today's chain, channels-last
# ---------------------------------------------------------------------------


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def conv_plain(x, w, b, d: int = 1, pre: bool = False, post: bool = False,
               res=None, acc=None, scale: float = 1.0) -> torch.Tensor:
    k = w.shape[-1]
    h = F.leaky_relu(x, SLOPE) if pre else x
    y = _cf(F.conv1d(_cf(h), w, b, padding=(k - 1) * d // 2, dilation=d))
    if post:
        y = F.leaky_relu(y, SLOPE)
    if res is not None:
        y = y + res
    if acc is not None:
        y = y + acc
    if scale != 1.0:
        y = y * scale
    return y.contiguous()


def up_plain(x, w, b, u: int) -> torch.Tensor:
    k = w.shape[-1]
    y = F.conv_transpose1d(_cf(F.leaky_relu(x, SLOPE)), w, b, stride=u,
                           padding=(k - u) // 2)
    return _cf(y).contiguous()


def post_plain(x, w) -> torch.Tensor:
    y = F.conv1d(_cf(F.leaky_relu(x, POST_SLOPE)), w, None,
                 padding=w.shape[-1] // 2)
    return torch.tanh(y.float())[:, 0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"vits_conv: {name} {tuple(t.shape)}, want {shape}")
    if t.dtype != BF16:
        raise ValueError(f"vits_conv: {name} is {t.dtype}; the kernel takes "
                         f"bfloat16")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"vits_conv: {name} must be contiguous and 16-byte "
                         f"aligned")


def _packed(name: str, packed: torch.Tensor | None) -> torch.Tensor:
    if packed is None:
        raise ValueError(f"vits_conv.{name}: on the card the kernel reads "
                         f"packed weights; pass packed= (pack at load)")
    return packed


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(x, pk, b, res, acc, out, C_out, taps, d, lo, P, p_shift, pre,
            post, scale, pl: Plan) -> None:
    B, T, C_in = x.shape
    _run(LIB.get().t2s_vits_conv_sm90, x.device, x.data_ptr(), pk.data_ptr(),
         _ptr(b), _ptr(res), _ptr(acc), out.data_ptr(), B, T, C_in, C_out,
         taps, d, lo, P, p_shift, int(pre), int(post), float(scale), pl.MT,
         pl.Rb, pl.nb, pl.NA, pl.NW, int(pl.resident))


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
         d: int = 1, *, packed: torch.Tensor | None = None,
         pre: bool = False, post: bool = False,
         res: torch.Tensor | None = None, acc: torch.Tensor | None = None,
         scale: float = 1.0) -> torch.Tensor:
    """x [B, T, C_in], w [C_out, C_in, k] (k odd), b [C_out] -> [B, T,
    C_out]: ``(act(conv(act(x)) + b) + res + acc) * scale``, same padding
    at dilation ``d``, ``act`` leaky ReLU 0.1 where ``pre`` / ``post`` ask.
    ``packed`` is :func:`pack` of ``w``, required on the card."""
    C_out, C_in, k = w.shape
    if x.dim() != 3 or x.shape[-1] != C_in or k % 2 == 0 or d < 1:
        raise ValueError(f"vits_conv.conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, d {d}")
    extra = [t for t in (b, res, acc, packed) if t is not None]
    if _on_cpu(x, w, *extra):
        return conv_plain(x, w, b, d, pre, post, res, acc, scale)
    B, T, _ = x.shape
    pl = plan(C_in, C_out, (k - 1) * d, k)
    _check("x", x, x.shape)
    for name, t in (("res", res), ("acc", acc)):
        if t is not None:
            _check(name, t, (B, T, C_out))
    if b is not None:
        _check("b", b, (C_out,))
    pk = _packed("conv", packed)
    _check("packed", pk, (C_out // pl.N, 1, k, C_in // pl.KC, pl.KC // 8,
                          pl.N, 8))
    out = torch.empty((B, T, C_out), dtype=BF16, device=x.device)
    conv.launches += 1
    _launch(x, pk, b, res, acc, out, C_out, k, d, (k - 1) * d // 2, 1, 1,
            pre, post, scale, pl)
    return out


def up(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, u: int, *,
       packed: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, C_in], w [C_in, C_out, 2u] (u even), b [C_out] -> [B, T u,
    C_out]: leaky ReLU 0.1, then the transposed convolution of stride u,
    padding u / 2.  ``packed`` is :func:`pack` ``(w, u)``, required on the
    card."""
    C_in, C_out, k = w.shape
    if x.dim() != 3 or x.shape[-1] != C_in or k != 2 * u or u % 2:
        raise ValueError(f"vits_conv.up: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, u {u}")
    extra = [t for t in (b, packed) if t is not None]
    if _on_cpu(x, w, *extra):
        return up_plain(x, w, b, u)
    B, T, _ = x.shape
    pl = plan(C_in, C_out, 2, 2 * u)
    _check("x", x, x.shape)
    if b is not None:
        _check("b", b, (C_out,))
    pk = _packed("up", packed)
    _check("packed", pk, (C_out // pl.N, u, 2, C_in // pl.KC, pl.KC // 8,
                          pl.N, 8))
    out = torch.empty((B, T * u, C_out), dtype=BF16, device=x.device)
    up.launches += 1
    _launch(x, pk, b, None, None, out, C_out, 2, 1, 1, u, u - u // 2, True,
            False, 1.0, pl)
    return out


def post(x: torch.Tensor, w: torch.Tensor, *,
         packed: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, C], w [1, C, k] (k odd) -> audio [B, T] f32: leaky ReLU
    0.01, the convolution (no bias), tanh in f32.  ``packed`` is
    :func:`pack_post` ``(w)``, required on the card."""
    _, C, k = w.shape
    if x.dim() != 3 or x.shape[-1] != C or w.shape[0] != 1 or k % 2 == 0:
        raise ValueError(f"vits_conv.post: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    extra = [] if packed is None else [packed]
    if _on_cpu(x, w, *extra):
        return post_plain(x, w)
    B, T, _ = x.shape
    if C % 8 or C > 256:
        raise ValueError(f"vits_conv.post: {C} channels; the kernel takes "
                         f"multiples of 8 up to 256")
    _check("x", x, x.shape)
    pk = _packed("post", packed)
    if pk.shape != (k, C) or pk.dtype != torch.float32 or \
            not pk.is_contiguous():
        raise ValueError(f"vits_conv.post: packed {tuple(pk.shape)} "
                         f"{pk.dtype}, want contiguous f32 {(k, C)}")
    out = torch.empty((B, T), dtype=torch.float32, device=x.device)
    post.launches += 1
    _run(LIB.get().t2s_vits_conv_post, x.device, x.data_ptr(), pk.data_ptr(),
         out.data_ptr(), B, T, C, k)
    return out


KERNELS = (conv, up, post)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {f"vits_conv.{fn.__name__}": fn.launches for fn in KERNELS}


def total_launches() -> int:
    return sum(fn.launches for fn in KERNELS)


reset_launch_counts()
