"""Text-to-speech CLI of the PyTorch port, on one CUDA GPU:

    python -m text2speech_tpu_torch.inference --weights model.npz \\
        --text "이 것은 제작되고 있는 중입니다." --out out.wav --fused_vocoder
    python -m text2speech_tpu_torch.inference --random_init 0 --fused_vocoder
    python -m text2speech_tpu_torch.inference --random_init 0 --int8_vocoder
    python -m text2speech_tpu_torch.inference --random_init 0 --int8_vocoder \
        --stream --stream_chunk_steps 64 -d 0.1

``--weights`` is the ``.npz`` written by ``export_torch_weights.py`` from the
JAX package's checkpoints; ``--taco_checkpoint DIR --waveglow_checkpoint
DIR`` read this package's own training checkpoints (``tacotron_train``,
``waveglow_train``); ``--taco_checkpoint DIR`` alone synthesizes without a
vocoder, by Griffin-Lim on the mel (``--griffin_lim_iters``, default 60);
``--random_init SEED`` synthesizes from seeded random weights when no
checkpoint exists (noise, but the whole path runs).
``--stream`` decodes in chunks and writes each piece of audio as soon as it
clears the vocoder's receptive field (the first after about one chunk, not
the whole decode).  ``--plot_dir DIR`` also draws the attention alignment
and the mel of an offline synthesis (vocoder or Griffin-Lim) into
``DIR/<stem of --out>_alignment.png`` and ``_mel.png``.

``--serve_slots N`` serves through the continuous-batching server
(:mod:`.server`): the lines of ``--texts_file`` (default: ``--text``) are the
request queue, requests join freed slots mid-flight, and one wav per session
is written as it completes (``out_<sid>.wav``).  With ``--http_port`` the
server is exposed over HTTP instead (:mod:`.http_serve`):

    python -m text2speech_tpu_torch.inference --random_init 0 --int8_vocoder \
        --serve_slots 4 --http_port 8080
    curl -s -X POST localhost:8080/synthesize \
        -d '{"text": "안녕하세요.", "seed": 1, "denoiser_strength": 0.1}' \
        -o out.wav

Without a GPU it raises, unless ``--device cpu`` asks for the CPU (small
configurations only; the vocoders run their kernels' plain versions
there).
"""

from __future__ import annotations

import argparse

import torch

from .config import HParams, WaveGlowConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="flat .npz of both models "
                     "(export_torch_weights.py)")
    src.add_argument("--random_init", type=int, metavar="SEED",
                     help="seeded random weights instead of a checkpoint")
    src.add_argument("--taco_checkpoint",
                     help="Tacotron training checkpoint directory of this "
                     "package (tacotron_train); without "
                     "--waveglow_checkpoint the mel is inverted by "
                     "Griffin-Lim")
    p.add_argument("--waveglow_checkpoint", default=None,
                   help="WaveGlow training checkpoint directory of this "
                   "package (waveglow_train)")
    p.add_argument("--griffin_lim_iters", type=int, default=60,
                   help="Griffin-Lim iterations of the vocoder-free path")
    p.add_argument("--text", default="이 것은 제작되고 있는 중입니다.")
    p.add_argument("--out", default="tone_440.wav")
    p.add_argument("--sigma", type=float, default=0.666)
    p.add_argument("--denoiser_strength", "-d", type=float, default=0.0)
    p.add_argument("--fused_vocoder", action="store_true",
                   help="vocode through the hand-written WN-layer kernels")
    p.add_argument("--int8_vocoder", action="store_true",
                   help="vocode through the int8 WN-layer kernels (implies "
                   "the fused path)")
    p.add_argument("--speaker_id", type=int, default=None)
    p.add_argument("--num_speakers", type=int, default=1)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--hparams", default=None)
    p.add_argument("--waveglow_config", default=None)
    p.add_argument("--plot_dir", default=None,
                   help="also render alignment + mel plots here "
                   "(reference inference.py:88-90 diagnostics)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="decoder steps (default: hparams max_decoder_steps)")
    p.add_argument("--stream", action="store_true",
                   help="incremental synthesis: decode in chunks and emit "
                   "audio as soon as each chunk clears the vocoder's "
                   "receptive field")
    p.add_argument("--stream_chunk_steps", type=int, default=64)
    p.add_argument("--serve_slots", type=int, default=0,
                   help="continuous-batching server mode: serve the input "
                   "texts through N decode slots (requests join freed slots "
                   "mid-flight), writing one wav per session as it "
                   "completes")
    p.add_argument("--texts_file", default=None,
                   help="one text per line; with --serve_slots these are "
                   "the request queue (default: --text)")
    p.add_argument("--http_port", type=int, default=None,
                   help="with --serve_slots: expose the server over HTTP "
                   "(POST /synthesize streams chunked WAV; GET /stats, "
                   "/healthz; 0 binds a free port) instead of serving "
                   "--texts_file")
    p.add_argument("--http_reload_token", default=None,
                   help="with --http_port: require this X-Reload-Token "
                   "header on POST /reload (the admin endpoint takes "
                   "filesystem paths; set a token when binding beyond "
                   "localhost)")
    p.add_argument("--serve_max_text_len", type=int, default=256,
                   help="encoder width every session pads to")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--no_serve_warmup", action="store_true",
                   help="with --http_port: skip the warm-up session before "
                   "the port is bound (the first real request then pays "
                   "the kernels' build and the first calls)")
    return p


def _read_texts(args) -> list:
    if not args.texts_file:
        return [args.text]
    with open(args.texts_file, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _request(text: str, speaker_id):
    return text if speaker_id is None else (text, speaker_id)


def synthesize_griffin_lim(args, hp, wg_cfg, device, keep_masks=None,
                           phase=None):
    """The vocoder-free path of ``--taco_checkpoint DIR`` alone, on
    ``device``: the Tacotron checkpoint's mel of ``--text``, then root
    ``inference.py``'s chain: ``dynamic_range_decompression``, max(1e-10,
    pinv(offline mel basis) @ .), ``** hp.power``, ``griffin_lim`` of
    ``--griffin_lim_iters`` rounds from a generator seeded 0 (or from
    ``phase``); writes ``--out`` (and with ``--plot_dir`` the alignment and
    the mel) and returns (the waveform [hop (T - 1)] f32, the mel's frame
    count T).
    ``keep_masks`` are the decoder's prenet masks (a test hands the JAX
    package's)."""
    from .dsp.audio import griffin_lim, mel_to_linear, save_wav
    from .dsp.mel import dynamic_range_decompression
    from .infer import N_SYMBOLS, Synthesizer, load_tacotron_checkpoint
    from .models.tacotron2 import Tacotron2
    from .models.waveglow import WaveGlow

    taco = Tacotron2(hp, N_SYMBOLS, args.num_speakers, device=device)
    load_tacotron_checkpoint(taco, args.taco_checkpoint)
    # the vocoder stays at its initialisation: text_to_mel needs no weights
    # of it (as the JAX package's load_synthesizer with wg_ckpt_dir=None)
    synth = Synthesizer(hp, taco.eval(), wg_cfg,
                        WaveGlow(wg_cfg, device=device).eval(),
                        use_denoiser=False)
    mel, lengths, align = synth.text_to_mel(
        [args.text], max_steps=args.max_steps, speaker_id=args.speaker_id,
        keep_masks=keep_masks, with_align=True)
    frames = int(lengths[0])
    draw_plots(args, mel, align, frames)
    if frames < 2:      # the inverse STFT of one frame has no samples
        raise ValueError(f"the decoder stopped after {frames} frame(s): "
                         f"Griffin-Lim needs two or more")
    S = mel_to_linear(dynamic_range_decompression(mel[:, :, :frames]),
                      hp) ** hp.power
    gen = torch.Generator(device=device).manual_seed(0)
    wav = griffin_lim(S, hp, gen, n_iters=args.griffin_lim_iters,
                      phase=phase)[0].cpu().numpy()
    save_wav(wav, args.out, args.sample_rate)
    return wav, frames


def draw_plots(args, mel: torch.Tensor, align: torch.Tensor,
               frames: int) -> None:
    """With ``--plot_dir``: the first row's alignment and mel, cut to
    ``frames``, as root ``inference.py`` draws them."""
    if not args.plot_dir:
        return
    from .utils.plotting import save_plots

    paths = save_plots(args.plot_dir, args.out,
                       mel[0, :, :frames].float().cpu().numpy(),
                       align[0, :frames].float().cpu().numpy(), args.text)
    print(f"wrote {' '.join(paths)}")


def synthesize_offline(args, synth):
    """The vocoder path of one text: ``text_to_mel`` (with the alignment,
    for ``--plot_dir``), the vocoder and the denoiser, as
    ``Synthesizer.synthesize``; writes ``--out`` and returns the waveform
    [frames * hop] f32."""
    from .dsp.audio import save_wav

    mel, lengths, align = synth.text_to_mel(
        [args.text], max_steps=args.max_steps, speaker_id=args.speaker_id,
        with_align=True)
    frames = int(lengths[0])
    audio = synth.mel_to_audio(mel[:, :, :frames].contiguous(), args.sigma,
                               denoiser_strength=args.denoiser_strength)
    wav = audio[0, :frames * synth.wg_cfg.upsample_stride].cpu().numpy()
    save_wav(wav, args.out, args.sample_rate)
    draw_plots(args, mel, align, frames)
    return wav


def serve_batch(args, srv) -> None:
    """Serve the texts as one queue of sessions; one wav per session."""
    import os
    import time

    import numpy as np

    from .dsp.audio import save_wav

    texts = _read_texts(args)
    # -d and --speaker_id apply to every session (HTTP clients set them per
    # request instead)
    ds = args.denoiser_strength if args.denoiser_strength > 0 else None
    sids = [srv.submit(_request(t, args.speaker_id), denoiser_strength=ds)
            for t in texts]
    base, ext = os.path.splitext(args.out)
    parts: dict = {sid: [] for sid in sids}
    first: dict = {}
    t0 = time.perf_counter()
    while not srv.idle:
        for ev in srv.step():
            if ev.final:
                path = f"{base}_{ev.sid}{ext or '.wav'}"
                wav = (np.concatenate(parts[ev.sid]) if parts[ev.sid]
                       else np.zeros((0,), np.float32))
                save_wav(wav, path, args.sample_rate)
                print(f"session {ev.sid} complete at "
                      f"t={time.perf_counter() - t0:.2f}s -> {path} "
                      f"({wav.shape[0]} samples)", flush=True)
            elif ev.audio is not None:
                if ev.sid not in first:
                    first[ev.sid] = time.perf_counter() - t0
                    print(f"session {ev.sid} first audio at "
                          f"t={first[ev.sid]:.2f}s", flush=True)
                parts[ev.sid].append(ev.audio)
    print(f"served {len(texts)} sessions through {args.serve_slots} slots "
          f"in {srv.stats['rounds']} rounds", flush=True)


def serve_http(args, synth, srv) -> None:
    """Expose the server over HTTP until interrupted."""
    import time

    from .http_serve import make_http_server

    if not args.no_serve_warmup:
        # before the port is bound: one throwaway session through the
        # scheduler with the denoiser on (serve mode keeps it available
        # whatever -d says; HTTP requests carry their own strengths) and,
        # on a multi-speaker model, one with and one without a speaker;
        # then both window widths and the short pass.  The first real
        # request then finds every kernel built and every library call
        # warm.
        t0 = time.perf_counter()
        wtext = _read_texts(args)[0]
        wds = args.denoiser_strength if args.denoiser_strength > 0 else 0.1
        speakers = [args.speaker_id]
        if args.num_speakers > 1:
            speakers.append(0 if args.speaker_id is None else None)
        for i, sp in enumerate(speakers):
            srv.submit(_request(wtext, sp),
                       denoiser_strength=wds if i == 0 else None)
        while not srv.idle:
            srv.step()
        srv.warm_window_widths()
        srv.warm_short_pass()
        print(f"server warmed in {time.perf_counter() - t0:.1f}s",
              flush=True)
    httpd, runner = make_http_server(
        srv, host="0.0.0.0", port=args.http_port,
        sample_rate=args.sample_rate, log_requests=True,
        # POST /reload {"taco_ckpt_dir" or "taco_npz", "wg_ckpt_dir"}
        reload_fn=synth.load_checkpoints,
        reload_token=args.http_reload_token)
    print(f"HTTP TTS server on :{httpd.server_address[1]} "
          f"({args.serve_slots} slots; POST /synthesize)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        runner.shutdown()


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.waveglow_checkpoint and not args.taco_checkpoint:
        parser.error("--waveglow_checkpoint needs --taco_checkpoint")
    if args.plot_dir:
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            parser.error("--plot_dir draws with matplotlib, which is not "
                         "installed")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text2speech_tpu_torch.inference needs a CUDA GPU "
                           "(no CUDA device is visible); pass --device cpu "
                           "to synthesize a small configuration on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = (HParams.load(args.hparams) if args.hparams
          else HParams(sample_rate=args.sample_rate))
    wg_cfg = (WaveGlowConfig.from_json(args.waveglow_config)
              if args.waveglow_config
              else WaveGlowConfig(sampling_rate=args.sample_rate))
    # serving keeps the denoiser available whatever -d says: HTTP requests
    # carry their own strengths
    use_denoiser = args.denoiser_strength > 0 or args.serve_slots > 0
    if args.taco_checkpoint and not args.waveglow_checkpoint:
        wav, frames = synthesize_griffin_lim(args, hp, wg_cfg,
                                             args.device)
        print(f"wrote {args.out} ({wav.shape[0]} samples at "
              f"{args.sample_rate} Hz, Griffin-Lim on {frames} mel frames, "
              f"{args.griffin_lim_iters} iterations)")
        return
    if args.weights or args.taco_checkpoint:
        from .infer import load_synthesizer

        synth = load_synthesizer(
            hp, args.weights, wg_cfg, use_denoiser=use_denoiser,
            num_speakers=args.num_speakers,
            use_fused_vocoder=args.fused_vocoder,
            int8_vocoder=args.int8_vocoder, device=args.device,
            taco_ckpt_dir=args.taco_checkpoint,
            wg_ckpt_dir=args.waveglow_checkpoint)
    else:
        from .infer import random_synthesizer

        synth = random_synthesizer(
            hp, wg_cfg, args.random_init, device=args.device,
            num_speakers=args.num_speakers, use_denoiser=use_denoiser,
            use_fused_vocoder=args.fused_vocoder,
            int8_vocoder=args.int8_vocoder)
    if args.serve_slots:
        from .server import make_server

        srv = make_server(synth, slots=args.serve_slots,
                          chunk_steps=args.stream_chunk_steps,
                          max_text_len=args.serve_max_text_len,
                          max_steps=args.max_steps, sigma=args.sigma)
        if args.http_port is not None:
            serve_http(args, synth, srv)
        else:
            serve_batch(args, srv)
        return
    if args.stream:
        import time

        import numpy as np

        from .dsp.audio import save_wav

        t0 = time.perf_counter()
        chunks = []
        for i, chunk in enumerate(synth.synthesize_incremental(
                args.text, sigma=args.sigma,
                chunk_steps=args.stream_chunk_steps,
                max_steps=args.max_steps,
                denoiser_strength=args.denoiser_strength,
                speaker_id=args.speaker_id)):
            chunks.append(chunk)
            print(f"chunk {i}: +{len(chunk)} samples at "
                  f"t={time.perf_counter() - t0:.2f}s")
        wav = np.concatenate(chunks)
        save_wav(wav, args.out, args.sample_rate)
        print(f"wrote {args.out} ({wav.shape[0]} samples at "
              f"{args.sample_rate} Hz, streamed in {len(chunks)} chunks)")
        return
    wav = synthesize_offline(args, synth)
    print(f"wrote {args.out} ({wav.shape[0]} samples at "
          f"{args.sample_rate} Hz)")


if __name__ == "__main__":
    main()
