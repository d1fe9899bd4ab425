"""Frame-axis chunked WaveGlow synthesis for arbitrarily long utterances
(counterpart of ``text2speech_tpu/models/chunked.py``).

The WaveGlow reverse pass has no sequential dependency across time, so a
long mel is split on the frame axis into windows of one width (chunk plus
overlap on each side), all windows are vocoded as ONE batch, and the
interiors are concatenated.  Why the result equals a single pass:

* the standard-normal draws are made ONCE for the full utterance and
  sliced per window, so a time position sees the same noise in every
  window that holds it;
* the first and last windows are clamped to the utterance's ends, not
  shortened, so their outer edges see the same conv zero padding as a
  single pass;
* interior seams differ only within the receptive field of the dilated WN
  stacks (and the upsampler's reach): with an overlap at least that wide
  (:func:`receptive_overlap_frames`, the default) the kept interiors match
  a single pass to float tolerance.  With the int8 vocoder this carries
  over: quantization is per row, so a window's row scales are the single
  pass's.

The windows go through whichever vocoder the caller holds: the plain f32
``WaveGlow`` or prepared fused weights of the bf16 or the int8 kernel path
(each has ``cfg`` and ``infer``); a window batch is an ordinary batch to
the kernels.

``mesh=`` shards the window batch over a data-parallel group
(``chunked.py:185-220``): the window count is padded to a multiple of the
data ranks with copies of the last window, each rank assembles and vocodes
its own contiguous block of windows, and the windows' audio is gathered,
so every rank returns the one-process result.  Sequence parallelism: one
long utterance's frame axis spread over the cards.
"""

from __future__ import annotations

import torch

from ..config import WaveGlowConfig
from .waveglow import noise_shapes


def noise_schedule(cfg: WaveGlowConfig) -> list:
    """Channel widths of the standard-normal draws one inference consumes,
    in consumption order: the initial draw, then one per early-injection
    point (descending flow index)."""
    return [shape[-1] for shape in noise_shapes(cfg, 1, 1)]


def draw_noise(cfg: WaveGlowConfig, generator: torch.Generator | None,
               batch: int, t_groups: int, device=None) -> tuple:
    """The full-utterance noise tuple for ``infer(noise=...)``: one f32
    [batch, t_groups, width] draw per entry of :func:`noise_schedule`, on
    ``generator``'s device (or ``device`` when there is no generator)."""
    if generator is not None:
        device = generator.device
    return tuple(torch.randn(shape, generator=generator, device=device)
                 for shape in noise_shapes(cfg, batch, t_groups))


def receptive_overlap_frames(cfg: WaveGlowConfig) -> int:
    """One-sided receptive field of the full flow stack, in mel frames.

    Each WN stack sees ``(kernel // 2) * (2 ** n_layers - 1)`` groups to
    each side; the flows compose, so the total is ``n_flows`` times that,
    rounded up to whole frames (``hop // n_group`` groups per frame), plus
    the upsampler's reach: each grouped conditioning step is a linear image
    of ``upsample_kernel / stride`` consecutive mel frames, which extends
    the window by ``r - 1`` frames."""
    per_flow = (cfg.wn_kernel_size // 2) * (2 ** cfg.wn_n_layers - 1)
    gpf = cfg.upsample_stride // cfg.n_group
    up_reach = cfg.upsample_kernel // cfg.upsample_stride - 1
    return -(-cfg.n_flows * per_flow // gpf) + up_reach


def infer_long(vocoder, spect: torch.Tensor, sigma: float = 1.0,
               chunk_frames: int = 256, overlap_frames: int | None = None,
               noise: tuple | None = None,
               generator: torch.Generator | None = None,
               mesh=None) -> torch.Tensor:
    """mel [B, n_mel, frames] -> audio [B, frames * hop], chunked on frames.

    All windows have the same width (``chunk + 2 * overlap`` frames), so
    the stacked ``[n_windows * B]`` batch runs as one pass.  An utterance
    no longer than one window takes a single pass.

    ``vocoder``: a ``WaveGlow`` (plain f32 pass) or the prepared weights
    of the bf16 or the int8 kernel path (``prepare_fused`` /
    ``prepare_fused_int8``).  ``overlap_frames`` defaults to
    :func:`receptive_overlap_frames`; a smaller value trades seam exactness
    for compute.  ``noise`` gives the full-utterance draws
    (:func:`draw_noise`); otherwise they come from ``generator``.

    ``mesh`` (:class:`..parallel.mesh.Mesh`): shard the stacked windows
    over its ``'data'`` ranks.  Every rank passes the same mel and the same
    noise (or generators seeded alike) and gets the whole audio.  An
    utterance of one window takes the single pass, unsharded, as in the
    JAX package."""
    cfg = vocoder.cfg
    if overlap_frames is None:
        overlap_frames = receptive_overlap_frames(cfg)
    hop = cfg.upsample_stride
    if hop % cfg.n_group != 0:
        raise ValueError("chunked synthesis needs hop % n_group == 0")
    gpf = hop // cfg.n_group          # audio groups per mel frame

    B, _, frames = spect.shape
    if noise is None:
        noise = draw_noise(cfg, generator, B, frames * gpf, spect.device)

    width = chunk_frames + 2 * overlap_frames
    if frames <= width:
        return vocoder.infer(spect, sigma, noise=noise)

    n_windows = -(-frames // chunk_frames)
    starts = [i * chunk_frames for i in range(n_windows)]
    win_starts = [min(max(s - overlap_frames, 0), frames - width)
                  for s in starts]
    n_pad = n_windows
    mine = slice(0, n_windows)
    if mesh is not None:
        from ..parallel.mesh import row_block

        nd = mesh.size()
        n_pad = -(-n_windows // nd) * nd
        mine = row_block(n_pad, mesh)
    # window-major rows (w * B + b): rank r's rows are its windows' block
    pad_starts = (win_starts + [win_starts[-1]] * (n_pad - n_windows))[mine]
    mel_w = torch.cat([spect[:, :, ws: ws + width] for ws in pad_starts])
    noise_w = tuple(
        torch.cat([z[:, ws * gpf: (ws + width) * gpf] for ws in pad_starts])
        for z in noise)
    audio_w = vocoder.infer(mel_w, sigma, noise=noise_w)
    if mesh is not None:
        from ..parallel.mesh import gather_rows

        audio_w = gather_rows(audio_w, mesh)
    audio_w = audio_w.reshape(n_pad, B, width * hop)

    pieces = []
    for i, (s, ws) in enumerate(zip(starts, win_starts)):
        keep = min(chunk_frames, frames - s)
        off = (s - ws) * hop
        pieces.append(audio_w[i, :, off: off + keep * hop])
    return torch.cat(pieces, dim=1)
