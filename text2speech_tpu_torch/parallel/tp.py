"""Tensor-parallel WaveGlow inference (counterpart of
``text2speech_tpu/parallel/tp.py``).

Megatron-style partitioning of the WN coupling stacks over ``p`` ranks:

* the dilated in-conv and the conditioning projection are column-parallel:
  a rank owns a gate-pair-consistent slice of the 2C output channels (tanh
  column i pairs with sigmoid column C + i, so both halves are cut by the
  same C/p slice, :func:`pair_cols`) and computes its gated activations
  from the replicated hidden state;
* the res/skip 1x1 is row-parallel: a rank contracts its C/p activations
  against its row slice, and ONE sum over ranks per WN layer rebuilds the
  residual and skip terms; the res/skip bias is kept whole and added once,
  after the sum;
* the end projection is row-parallel over the skip sum (one small sum of
  the (b, log_s) coupling terms per flow);
* upsampling, the invertible 1x1 convs, the affine coupling and the noise
  are replicated.

Where the ranks live.  A rank's work is a function over the shards THIS
process holds.  Without a ``torch.distributed`` group one process holds all
``n_model`` shards on one device and sums their partials in rank order:
that is how one GPU and the CPU tests run the path, and it is the
counterpart of the JAX package's virtual-device mesh.  With a group, a
process holds the shard of its own rank and the per-layer sum is an
``all_reduce`` (NCCL between GPUs, gloo on the CPU).  Every rank must then be
given the same mel and the same noise (the same ``noise=`` tuple, or
generators seeded alike).  With a data x model :class:`.mesh.Mesh`
(``mesh=``) a rank vocodes its row block of the batch with its model group,
and the audio rows are gathered, so every rank returns the whole batch.

``fused=True`` runs each shard's layer through the partial WN-layer kernels
(:func:`..ops.wn_block.wn_layer_partial`, and with ``int8=True``
:func:`..ops.wn_block_int8.wn_layer_partial_int8` for layers 1..L-1; layer 0
stays in the compute dtype, with the start projection composed onto its
taps).  ``fused=False`` is the plain per-rank f32 math.  The port pads no
time axis: the kernels take the true length at run time.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.waveglow import WaveGlow, noise_shapes, upsample_group
from ..ops import wn_block as wb
from ..ops import wn_block_int8 as wq
from .mesh import DATA_AXIS, MODEL_AXIS, gather_rows, row_block

F32 = torch.float32
PARTIAL_KERNELS = (wb.wn_layer_partial, wq.wn_layer_partial_int8)


def reset_launch_counts() -> None:
    for fn in PARTIAL_KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of the two partial-layer kernels since the last reset."""
    return {fn.__name__: fn.launches for fn in PARTIAL_KERNELS}


def pair_cols(C: int, p: int, i: int) -> np.ndarray:
    """Rank ``i``'s columns of a 2C-wide gated pre-activation: its C/p tanh
    columns and the matching C/p sigmoid columns."""
    s = C // p
    return np.r_[i * s:(i + 1) * s, C + i * s:C + (i + 1) * s]


@torch.no_grad()
def shard_waveglow_params(model: WaveGlow, n_model: int, int8: bool = False,
                          ranks: Sequence[int] | None = None) -> dict:
    """Split every WN tensor of ``model`` (weight norm already folded, at
    load) across ``n_model`` ranks, as ``tp.py:62 shard_waveglow_params``.

    Returns ``{"upsample": {kernel, bias}, "convinv{k}": W, "wn{k}": blk}``
    in f32 and the JAX package's layouts.  In ``blk``, ``in{li}`` /
    ``cond{li}`` hold ``{"w": [R, 3, C, 2C/p] / [R, M, 2C/p], "b": [R,
    2C/p]}``, ``rs{li}`` ``{"w": [R, C/p, rs_out], "b": [rs_out]}`` (the bias
    whole), ``end`` ``{"w": [R, C/p, E], "b": [E]}``; ``start_k`` /
    ``start_b`` are replicated.  The leading axis runs over ``ranks``
    (default: all ``n_model``), so a process of a distributed group can cut
    only its own shard.

    ``int8``: layers 1..L-1 are quantized per rank by
    :func:`..ops.wn_block_int8.quantize_cols` into ``{"q", "s", "b"}`` (``q``
    keeps the ``[.., K, N]`` layout).  A rank's partial is dequantized with
    its own scales before the sum, so the ranks need not agree on scales.
    Layer 0 stays floating point: its taps are composed with the start
    projection."""
    cfg = model.cfg
    C, L, p = cfg.wn_n_channels, cfg.wn_n_layers, n_model
    if p < 1 or C % p:
        raise ValueError(f"wn_n_channels {C} does not split {p} ways")
    ranks = list(range(p)) if ranks is None else list(ranks)
    if any(not 0 <= i < p for i in ranks):
        raise ValueError(f"ranks {ranks} outside [0, {p})")
    s = C // p
    cols = [torch.from_numpy(pair_cols(C, p, i)).to(model.upsample_k.device)
            for i in ranks]

    def f32(t):     # a copy: the shards are a snapshot of the checkpoint
        return t.detach().to(F32, copy=True)

    def q_stack(ws, b):
        qs = [wq.quantize_cols(w) for w in ws]
        return {"q": torch.stack([q for q, _ in qs]),
                "s": torch.stack([sc for _, sc in qs]), "b": b}

    out: dict = {"upsample": {"kernel": f32(model.upsample_k),
                              "bias": f32(model.upsample_b)}}
    for k, wn in enumerate(model.wn):
        out[f"convinv{k}"] = f32(model.convinv[k])
        blk = {"start_k": f32(wn.start_k), "start_b": f32(wn.start_b)}
        for li in range(L):
            w_in, b_in = f32(wn.in_w[li]), f32(wn.in_b[li])
            w_c, b_c = f32(wn.cond_w[li]), f32(wn.cond_b[li])
            w_rs, b_rs = f32(wn.rs_w[li]), f32(wn.rs_b[li])
            in_w = [w_in[..., c] for c in cols]
            in_b = torch.stack([b_in[c] for c in cols])
            c_w = [w_c[:, c] for c in cols]
            c_b = torch.stack([b_c[c] for c in cols])
            rs_w = [w_rs[i * s:(i + 1) * s] for i in ranks]
            if int8 and li > 0:
                blk[f"in{li}"] = q_stack(in_w, in_b)
                blk[f"cond{li}"] = q_stack(c_w, c_b)
                blk[f"rs{li}"] = q_stack(rs_w, b_rs)
            else:
                blk[f"in{li}"] = {"w": torch.stack(in_w), "b": in_b}
                blk[f"cond{li}"] = {"w": torch.stack(c_w), "b": c_b}
                blk[f"rs{li}"] = {"w": torch.stack(rs_w), "b": b_rs}
        end_w = f32(wn.end_w)
        blk["end"] = {"w": torch.stack([end_w[i * s:(i + 1) * s]
                                        for i in ranks]),
                      "b": f32(wn.end_b)}
        out[f"wn{k}"] = blk
    return out


def _sum_ranks(parts: list, group) -> torch.Tensor:
    """The per-layer collective: this process's partials in rank order,
    then the sum over the processes of ``group``."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=group)
    return total


def _end_projection(blk: dict, skip: torch.Tensor, ranks, C: int, p: int,
                    group) -> torch.Tensor:
    """Row-parallel end projection over the replicated skip sum."""
    s = C // p
    parts = [skip[..., i * s:(i + 1) * s] @ blk["end"]["w"][j]
             for j, i in enumerate(ranks)]
    return _sum_ranks(parts, group) + blk["end"]["b"]


def _wn_tp(blk: dict, x0: torch.Tensor, cond: torch.Tensor, L: int, ranks,
           p: int, group) -> torch.Tensor:
    """One WN coupling stack, the plain per-rank math in f32 (``tp.py:134
    _wn_tp``): -> (b, log_s) [B, T, 2 n_half]."""
    C = blk["start_k"].shape[-1]
    x = x0 @ blk["start_k"] + blk["start_b"]
    skip = None
    for li in range(L):
        d = 2 ** li
        parts = []
        for j in range(len(ranks)):
            w_in, b_in = blk[f"in{li}"]["w"][j], blk[f"in{li}"]["b"][j]
            in_act = F.conv1d(x.transpose(1, 2), w_in.permute(2, 1, 0), b_in,
                              padding=d, dilation=d).transpose(1, 2)
            in_act = in_act + (cond @ blk[f"cond{li}"]["w"][j]
                               + blk[f"cond{li}"]["b"][j])
            s = in_act.shape[-1] // 2
            acts = torch.tanh(in_act[..., :s]) * torch.sigmoid(in_act[..., s:])
            parts.append(acts @ blk[f"rs{li}"]["w"][j])
        rs = _sum_ranks(parts, group) + blk[f"rs{li}"]["b"]
        if li < L - 1:
            x = x + rs[..., :C]
            skip = rs[..., C:] if skip is None else skip + rs[..., C:]
        else:
            skip = rs if skip is None else skip + rs
    return _end_projection(blk, skip, ranks, C, p, group)


def prepare_fused_shards(blk: dict, L: int, compute_dtype,
                         int8: bool) -> dict:
    """One flow's shards as the partial kernels take them, once per
    checkpoint: weights cast to ``compute_dtype`` and contiguous, layer 0's
    taps composed with the start projection per rank (folded in f32, then
    cast, as ``tp.py:220-229``), int8 payloads transposed to output-major."""
    cd = compute_dtype
    R = blk["in0"]["w"].shape[0]

    def cw(t):
        return t.to(cd).contiguous()

    def cf(t):
        return t.to(F32).contiguous()

    first = []
    for j in range(R):
        wp, b_all, b_edge = wb.fold_first_taps(
            blk["start_k"], blk["start_b"], blk["in0"]["w"][j],
            blk["in0"]["b"][j])
        first.append((cw(wp), b_all, cw(blk["cond0"]["w"][j]),
                      cf(blk["cond0"]["b"][j]), cw(blk["rs0"]["w"][j]),
                      b_edge))
    layers = [first]
    for li in range(1, L):
        per_rank = []
        for j in range(R):
            i_, c_, r_ = blk[f"in{li}"], blk[f"cond{li}"], blk[f"rs{li}"]
            if int8:
                per_rank.append((
                    wq.to_output_major(i_["q"][j]), cf(i_["s"][j]),
                    cf(i_["b"][j]), wq.to_output_major(c_["q"][j]),
                    cf(c_["s"][j]), cf(c_["b"][j]),
                    wq.to_output_major(r_["q"][j]), cf(r_["s"][j])))
            else:
                per_rank.append((cw(i_["w"][j]), cf(i_["b"][j]),
                                 cw(c_["w"][j]), cf(c_["b"][j]),
                                 cw(r_["w"][j])))
        layers.append(per_rank)
    return {"layers": layers}


def _wn_tp_fused(blk: dict, shards: dict, x0: torch.Tensor,
                 cond_cd: torch.Tensor, L: int, ranks, p: int, group,
                 n_valid: int, compute_dtype,
                 spect_q: tuple | None = None) -> torch.Tensor:
    """One WN coupling stack through the partial kernels (``tp.py:182
    _wn_tp_fused``): every held shard runs its share of a layer in one
    launch, ONE sum over ranks per layer rebuilds the res/skip term, and the
    bias, the residual add and the skip sum follow in f32.  ``x0`` [B, T,
    n_half] f32, ``cond_cd`` the grouped conditioning in ``compute_dtype``.

    ``spect_q = (qspect, sspect)`` switches layers 1..L-1 to the int8
    partial kernel: the replicated hidden state is requantized per row
    after each residual add, and every shard dequantizes its partial with
    its own weight scales before the sum.

    Rows at or past ``n_valid`` of the hidden state are zeroed after every
    residual add, as the whole-layer kernels zero their ``x_out``: the
    res/skip bias would otherwise leave bias-driven values there, and the
    next layer's taps would read them."""
    C = blk["start_k"].shape[-1]
    cd = compute_dtype
    T = x0.shape[1]
    vmask = None
    if n_valid < T:
        vmask = (torch.arange(T, device=x0.device) < n_valid)[None, :, None]

    def zero_tail(x):
        return x if vmask is None else torch.where(vmask, x, 0.0)

    x0_cd = x0.to(cd).contiguous()
    parts = [wb.wn_layer_partial(x0_cd, cond_cd, wp, b_all, w_c, b_c, w_rs, 1,
                                 b_edge=b_edge, n_valid=n_valid)
             for wp, b_all, w_c, b_c, w_rs, b_edge in shards["layers"][0]]
    rs = _sum_ranks(parts, group) + blk["rs0"]["b"]
    xh = x0.to(F32) @ blk["start_k"] + blk["start_b"]
    x = zero_tail(xh + rs[..., :C])
    skip = rs[..., C:]
    if spect_q is not None:
        qspect, sspect = spect_q
        qx, sx = wq.quantize_rows(x)

    for li in range(1, L):
        if spect_q is not None:
            parts = [wq.wn_layer_partial_int8(qx, sx, qspect, sspect, *w,
                                              2 ** li, n_valid=n_valid)
                     for w in shards["layers"][li]]
        else:
            x_cd = x.to(cd)
            parts = [wb.wn_layer_partial(x_cd, cond_cd, *w, 2 ** li,
                                         n_valid=n_valid)
                     for w in shards["layers"][li]]
        rs = _sum_ranks(parts, group) + blk[f"rs{li}"]["b"]
        if li < L - 1:
            x = zero_tail(x + rs[..., :C])
            skip = skip + rs[..., C:]
            if spect_q is not None:
                qx, sx = wq.quantize_rows(x)
        else:
            skip = skip + rs
    return _end_projection(blk, skip, ranks, C, p, group)


class TPWaveGlowServer:
    """Build-once tensor-parallel WaveGlow vocoder (``tp.py:283
    TPWaveGlowServer``).

    Construction cuts the weights (:func:`shard_waveglow_params`) and
    prepares them for the kernels once; every call then vocodes a mel batch.
    ``n_model`` ranks without a ``group``: all shards on the model's device
    (one GPU, or the CPU).  With ``group`` (a ``torch.distributed`` process
    group): ``n_model`` is its size and this process holds its own rank's
    shard; every rank must call with the same mel, sigma and noise.  With
    ``mesh`` (a data x model :class:`.mesh.Mesh`): the model group is the
    mesh's, and the batch is split over its data ranks, whose audio is
    gathered (every rank calls with the global mel and noise).

    ``fused`` (default) runs the shards through the partial kernels in
    ``compute_dtype`` (on a GPU the kernels take bf16, the default; the CPU
    tests run the plain versions in f32 to hold them against the JAX
    package); ``fused=False`` is the plain f32 path.  ``int8`` (needs
    ``fused`` and at least two WN layers) serves layers 1..L-1 through the
    int8 partial kernel."""

    def __init__(self, model: WaveGlow, n_model: int | None = None,
                 group=None, fused: bool = True,
                 compute_dtype=torch.bfloat16, int8: bool = False,
                 mesh=None):
        cfg = model.cfg
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if group is not None:
                raise ValueError("give a process group or a mesh, not both")
            group = mesh.group(MODEL_AXIS)
        self.group = group
        if group is not None:
            import torch.distributed as dist

            size = dist.get_world_size(group)
            if n_model not in (None, size):
                raise ValueError(f"n_model {n_model} but the group has "
                                 f"{size} ranks")
            self.n_model = size
            self.ranks = [dist.get_rank(group)]
        else:
            if n_model is None:
                raise ValueError("give n_model or a process group")
            self.n_model = n_model
            self.ranks = list(range(n_model))
        if int8 and not fused:
            raise ValueError("int8 runs through the fused partial kernels")
        if int8 and cfg.wn_n_layers < 2:
            raise ValueError("the int8 path keeps layer 0 floating point: "
                             "it needs wn_n_layers >= 2")
        self.fused, self.int8, self.compute_dtype = fused, int8, compute_dtype
        self.device = model.upsample_k.device
        self.params = shard_waveglow_params(model, self.n_model, int8=int8,
                                            ranks=self.ranks)
        self._w_inv = [torch.linalg.inv(self.params[f"convinv{k}"])
                       for k in range(cfg.n_flows)]
        self._shards = None
        if fused:
            self._shards = [
                prepare_fused_shards(self.params[f"wn{k}"], cfg.wn_n_layers,
                                     compute_dtype, int8)
                for k in range(cfg.n_flows)]

    @torch.no_grad()
    def __call__(self, spect: torch.Tensor, sigma: float = 0.666,
                 noise: tuple | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """mel [B, n_mel, frames] -> audio [B, frames * hop] f32.  ``noise``:
        the standard-normal draws in ``WaveGlow.noise_shapes`` order;
        otherwise drawn from ``generator``."""
        cfg, L, p = self.cfg, self.cfg.wn_n_layers, self.n_model
        up = self.params["upsample"]
        rows = slice(None)
        if self.mesh is not None:       # this rank's data rows
            rows = row_block(spect.shape[0], self.mesh, DATA_AXIS)
        cond = upsample_group(spect[rows].to(self.device, F32), up["kernel"],
                              up["bias"], cfg)
        B, Tg, _ = cond.shape
        # the draws are made at the global batch's shape
        shapes = noise_shapes(cfg, spect.shape[0], Tg)
        draws = iter(noise) if noise is not None else None

        def next_noise(i):
            if draws is None:
                z = torch.randn(shapes[i], generator=generator,
                                device=self.device)
            else:
                z = next(draws)
                if tuple(z.shape) != shapes[i]:
                    raise ValueError(f"noise draw {tuple(z.shape)}, want "
                                     f"{shapes[i]}")
            return sigma * z[rows].to(self.device, F32)

        if self.fused:
            cond_cd = cond.to(self.compute_dtype).contiguous()
            sq = None
            if self.int8:
                sq = tuple(t.contiguous() for t in wq.quantize_rows(cond))

        x = next_noise(0)
        n_draw = 1
        for k in reversed(range(cfg.n_flows)):
            blk = self.params[f"wn{k}"]
            n_half = x.shape[-1] // 2
            x0, x1 = x[..., :n_half], x[..., n_half:]
            if self.fused:
                wn_out = _wn_tp_fused(blk, self._shards[k], x0, cond_cd, L,
                                      self.ranks, p, self.group, Tg,
                                      self.compute_dtype, spect_q=sq)
            else:
                wn_out = _wn_tp(blk, x0, cond, L, self.ranks, p, self.group)
            x1 = (x1 - wn_out[..., :n_half]) * torch.exp(-wn_out[..., n_half:])
            x = torch.cat([x0, x1], dim=-1) @ self._w_inv[k].T
            if k % cfg.n_early_every == 0 and k > 0:
                x = torch.cat([next_noise(n_draw), x], dim=-1)
                n_draw += 1
        audio = x.reshape(B, Tg * cfg.n_group)
        if self.mesh is not None:
            audio = gather_rows(audio, self.mesh, DATA_AXIS)
        return audio


def infer_waveglow_tp(model: WaveGlow, spect: torch.Tensor, sigma: float,
                      n_model: int | None = None, group=None,
                      noise: tuple | None = None,
                      generator: torch.Generator | None = None,
                      fused: bool = False, int8: bool = False,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One-shot tensor-parallel WaveGlow inference: mel [B, n_mel, frames]
    -> audio [B, samples], equal to ``model.infer(..., noise=noise)`` to
    float tolerance (``fused=False``, the default) or to the fused serving
    path's.  Builds a :class:`TPWaveGlowServer` per call, which cuts the
    weights anew: hold the server for repeated vocoding."""
    server = TPWaveGlowServer(model, n_model, group=group, fused=fused,
                              compute_dtype=compute_dtype, int8=int8)
    return server(spect, sigma, noise=noise, generator=generator)
