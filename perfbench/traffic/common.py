"""What the traffic kinds share: the program's precision switches, the
system under test built from the benchmark's weights, and the steps of a
run that frees the program before the reference runs."""

from __future__ import annotations

import gc


def set_precision(torch, control: bool) -> None:
    """float32 stays float32 (TF32 off for products and convolutions, as
    the port's inference CLI and trainers set it); the control turns TF32
    on, the program's own lower-precision switch."""
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control


def build_synthesizer(ctx, taco_sd: dict, wg_sd: dict):
    """The port's ``Synthesizer`` over the benchmark's weights, through its
    reference-checkpoint loaders (``convert.py``): the fused bf16 vocoder
    and the denoiser, or with ``ctx.control`` the int8 vocoder."""
    from text2speech_tpu_torch import convert
    from text2speech_tpu_torch.config import HParams, WaveGlowConfig
    from text2speech_tpu_torch.infer import Synthesizer

    hp = HParams.from_dict(ctx.cfg["tacotron"])
    wgc = WaveGlowConfig(**ctx.cfg["waveglow"])
    taco = convert.tacotron_module_from_torch(taco_sd, hp, device=ctx.device)
    wg = convert.waveglow_module_from_torch(wg_sd, wgc, device=ctx.device)
    serving = ctx.cfg["serving"]
    return Synthesizer(hp, taco, wgc, wg,
                       use_denoiser=serving["use_denoiser"],
                       use_fused_vocoder=serving["use_fused_vocoder"],
                       int8_vocoder=ctx.control)


def sync(torch, device: str):
    if device == "cuda":
        return torch.cuda.synchronize
    return None


def memory_peak(torch, device: str) -> int:
    if device == "cuda":
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()
    return 0


def free(torch, device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def pct(values: list, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
