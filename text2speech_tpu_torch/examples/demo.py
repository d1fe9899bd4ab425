"""Worked example: the port's whole API on a synthetic corpus (counterpart
of the JAX package's ``examples/demo.py``), on one GPU or, with
``--device cpu``, on the CPU in a few minutes:

    python -m text2speech_tpu_torch.examples.demo [--workdir DIR] \\
        [--steps 5] [--device cuda|cpu]

(without ``--workdir`` it writes into a new temporary directory, which it
names on its first line)

1. builds a tiny synthetic Korean corpus (sine "speech" + transcript.txt)
2. preprocesses it to reference-format .npz (``data/preprocess.py``)
3. trains a small Tacotron-2 for a few steps (``TacotronTrainer.fit``)
4. trains a small WaveGlow for a few steps (``WaveGlowTrainer.fit``)
5. synthesizes a sentence end to end and writes out.wav
6. serves the same chain tensor-parallel: two shards on the one device
   (``TPSynthesizer(n_model=2)``), or one per card under ``torchrun``;
   writes out_tp.wav and holds it against step 5's audio
7. streams one utterance's audio incrementally (first-audio latency path)
8. serves two concurrent streaming sessions through one batched decode
9. runs the continuous-batching server (requests join freed slots mid-flight)
10. exposes it over HTTP (chunked-transfer WAV streaming)
11. mixes per-request denoiser strengths in one batch (streaming denoise)

The configurations are the JAX demo's, but for the WaveGlow width: 128
channels, not 32, because on a card the tensor-parallel vocoder's partial
kernels take a whole 128-channel layer cut into shares of at least 64
columns.  The last line lists the kernel launches of the whole run.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import tempfile
import threading

import numpy as np
import torch

TEXTS = ["안녕하세요.", "반갑습니다.", "오늘 날씨가 좋네요.", "감사합니다."]
# step 6 against step 5, the bounds of tests/test_torch_tp_serve.py: in f32
# both run the same operations in the same order but for the per-layer sum
# over the ranks and the sliced LSTM products (1e-5); in bf16, the default
# on a card, the whole chain rounds to bf16 (relative L2 under 0.5)
TP_F32_ATOL = 1e-5
TP_BF16_REL_L2 = 0.5


def configs(steps: int):
    """The JAX demo's tiny configurations (``examples/demo.py:50-64``),
    the WaveGlow at 128 channels."""
    from ..config import HParams, WaveGlowConfig

    hp = HParams(
        sample_rate=22050, trim_silence=False, batch_size=2,
        embedding_size=32, enc_conv_num_layers=1, enc_conv_channels=32,
        attention_rnn_dim=32, decoder_rnn_dim=32, attention_dim=16,
        attention_location_n_filters=4, attention_location_kernel_size=11,
        prenet_dim=16, postnet_embedding_dim=16, postnet_n_convolutions=2,
        max_decoder_steps=40, checkpoint_interval=steps,
    )
    wg_cfg = WaveGlowConfig(
        n_mel_channels=hp.n_mel_channels, n_flows=2, n_group=8,
        n_early_every=4, wn_n_layers=2, wn_n_channels=128,
        sampling_rate=hp.sample_rate, batch_size=2, segment_length=4096,
        iters_per_checkpoint=steps,
    )
    return hp, wg_cfg


def launch_counts() -> dict:
    """Kernel launches since the process started, by wrapper."""
    from ..ops import gated, wn_backward, wn_block, wn_block_int8
    from ..parallel import tp

    return {**wn_block.launch_counts(), **wn_block_int8.launch_counts(),
            **tp.launch_counts(), **gated.launch_counts(),
            **wn_backward.launch_counts()}


def write_corpus(corpus: str, sample_rate: int) -> list:
    """Four sine "utterances" in the KSS layout; returns the wav paths."""
    from scipy.io import wavfile

    os.makedirs(os.path.join(corpus, "1"), exist_ok=True)
    rng = np.random.RandomState(0)
    lines, paths = [], []
    for i, t in enumerate(TEXTS):
        n = 11025 + 2000 * i
        tt = np.arange(n) / sample_rate
        sig = (0.4 * np.sin(2 * np.pi * (180 + 40 * i) * tt)
               + 0.01 * rng.randn(n))
        path = os.path.join(corpus, "1", f"u{i}.wav")
        wavfile.write(path, sample_rate, (sig * 32767).astype(np.int16))
        lines.append(f"1/u{i}.wav|{t}|{t}|dur")
        paths.append(path)
    with open(os.path.join(corpus, "transcript.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    with open(os.path.join(corpus, "val.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:2]))
    return paths


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default=None,
                        help="output directory (default: a new temporary "
                             "directory)")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the demo needs a CUDA GPU (no CUDA device is "
                           "visible); pass --device cpu to run it on the CPU")
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="t2s_demo_")
    os.makedirs(args.workdir, exist_ok=True)
    print(f"writing into {args.workdir}")
    device = args.device

    from ..convert import load_waveglow, variables_from_trainable
    from ..data.preprocess import preprocess_corpus, write_metadata
    from ..dsp.audio import save_wav
    from ..http_serve import make_http_server
    from ..infer import Synthesizer
    from ..parallel.serve import TPSynthesizer
    from ..server import make_server
    from ..train.tacotron import TacotronTrainer
    from ..train.waveglow import WaveGlowTrainer

    hp, wg_cfg = configs(args.steps)

    # 1. synthetic corpus ---------------------------------------------------
    corpus = os.path.join(args.workdir, "corpus")
    wav_paths = write_corpus(corpus, hp.sample_rate)

    # 2. preprocess ---------------------------------------------------------
    pp_out = os.path.join(args.workdir, "preprocessed")
    meta = preprocess_corpus(hp, corpus, pp_out, num_workers=2,
                             device_batch=4, device=device)
    write_metadata(meta, pp_out, hp)
    print(f"preprocessed {len(meta)} utterances into {pp_out}")

    # 3. train Tacotron-2 a few steps ---------------------------------------
    run_dir = os.path.join(args.workdir, "taco_run")
    os.makedirs(run_dir, exist_ok=True)
    trainer = TacotronTrainer(hp, [corpus], run_dir, device=device)
    trainer.fit(args.steps)
    trainer.logger.close()
    print(f"tacotron trained {args.steps} steps")

    # 4. train WaveGlow a few steps ------------------------------------------
    filelist = os.path.join(args.workdir, "train_files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(wav_paths) + "\n")
    wg_dir = os.path.join(args.workdir, "wg_run")
    wg_trainer = WaveGlowTrainer(wg_cfg, filelist, wg_dir, device=device)
    wg_trainer.fit(args.steps)
    wg_trainer.logger.close()
    print(f"waveglow trained {args.steps} steps")

    # 5. synthesize ----------------------------------------------------------
    # the trained Tacotron is the serving module; the trained WaveGlow's
    # weights fold into the inference module
    taco = trainer.model.eval()
    waveglow = load_waveglow(variables_from_trainable(wg_trainer.model),
                             wg_cfg, device=device)
    synth = Synthesizer(hp, taco, wg_cfg, waveglow, use_denoiser=False)
    out_path = os.path.join(args.workdir, "out.wav")
    wav = synth.synthesize_to_files([TEXTS[0]], [out_path])[0]
    print(f"wrote {out_path} ({wav.shape[0]} samples)")

    # 6. tensor-parallel serving ---------------------------------------------
    # text -> mel -> waveform with the decoder's LSTMs cut by columns and
    # each WN layer cut into two shares summed per layer: both shards on
    # this device here (one process); under torchrun give group= instead
    tps = TPSynthesizer(hp, taco, wg_cfg, waveglow, n_model=2, chunk_steps=8)
    tp_wav = tps.synthesize([TEXTS[0]])[0]
    tp_path = os.path.join(args.workdir, "out_tp.wav")
    save_wav(tp_wav, tp_path, hp.sample_rate)
    err = float(np.abs(tp_wav - wav).max()) if tp_wav.shape == wav.shape \
        else float("inf")
    rel = (float(np.linalg.norm(tp_wav - wav) / np.linalg.norm(wav))
           if tp_wav.shape == wav.shape else float("inf"))
    f32 = tps.compute_dtype == torch.float32
    ok = err <= TP_F32_ATOL if f32 else rel < TP_BF16_REL_L2
    print(f"wrote {tp_path} (tensor-parallel, 2 shards on {device} in "
          f"{str(tps.compute_dtype).removeprefix('torch.')}; against step 5: "
          f"{tp_wav.shape[0]} vs {wav.shape[0]} samples, max_abs_err "
          f"{err:.3g}, rel_l2 {rel:.3g}; bound "
          + (f"max_abs {TP_F32_ATOL}" if f32 else f"rel_l2 {TP_BF16_REL_L2}")
          + ")")
    if not ok:
        raise RuntimeError("the tensor-parallel audio disagrees with step 5's")

    # 7. streaming synthesis (first audio before the full decode) ------------
    # audio chunks arrive as soon as the decoded mel clears the vocoder's
    # receptive field; the concatenation equals step 5's single pass for
    # the same seed (same decode, same noise stream)
    chunks = list(synth.synthesize_incremental(TEXTS[0], chunk_steps=8))
    stream_wav = np.concatenate(chunks)
    print(f"streamed {len(chunks)} audio chunks ({stream_wav.shape[0]} "
          f"samples; first chunk after ~{8 + 8} of {hp.max_decoder_steps} "
          f"decoder steps)")

    # 8. concurrent streaming sessions ---------------------------------------
    # N utterances decode in one lockstep batched decode while each
    # session's audio streams out as its own frames clear the vocoder window
    sessions = {0: 0, 1: 0}
    for row, chunk in synth.synthesize_incremental_batch(TEXTS[:2],
                                                         chunk_steps=8):
        sessions[row] += len(chunk)
    print("served 2 concurrent streaming sessions: "
          + ", ".join(f"row {r}: {n} samples" for r, n in sessions.items()))

    # 9. continuous batching --------------------------------------------------
    # more requests than slots: sessions are admitted into freed slots
    # mid-flight while the fixed-shape decode batch keeps running, and each
    # session's audio is a function of (text, seed) only
    srv = make_server(synth, slots=2, chunk_steps=8, max_text_len=96)
    for text in [TEXTS[0], TEXTS[1], "세 번째 요청."]:
        srv.submit(text)
    served: dict = {}
    while not srv.idle:
        for ev in srv.step():
            if ev.audio is not None:
                served[ev.sid] = served.get(ev.sid, 0) + len(ev.audio)
    print(f"continuous batching: 3 requests through 2 slots in "
          f"{srv.stats['rounds']} rounds: "
          + ", ".join(f"sid {s}: {n} samples"
                      for s, n in sorted(served.items())))

    # 10. HTTP serving ---------------------------------------------------------
    # the continuous batcher behind a stdlib HTTP server: POST /synthesize
    # streams chunked-transfer WAV as the session decodes; a per-request
    # "sigma" sets the flow temperature; /stats exposes the scheduler
    httpd, runner = make_http_server(
        make_server(synth, slots=2, chunk_steps=8, max_text_len=96), port=0,
        sample_rate=hp.sample_rate)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/synthesize", body=json.dumps(
            {"text": TEXTS[0], "seed": 7, "sigma": 0.6}))
        resp = conn.getresponse()
        wav_bytes = resp.read()
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.shutdown()
    print(f"HTTP serving: POST /synthesize on :{port} streamed "
          f"{len(wav_bytes)} WAV bytes (status {resp.status}); /stats: "
          f"{stats['completed']} completed, {stats['emitted_samples']} "
          f"samples emitted")

    # 11. per-request quality knobs -------------------------------------------
    # the reference applies its bias-subtraction denoiser offline
    # (waveglow/denoiser.py); here it streams: sessions with different
    # strengths share one batched windowed-STFT call per round, equal to
    # the offline denoiser over each session's raw audio
    den_synth = Synthesizer(hp, taco, wg_cfg, waveglow, use_denoiser=True,
                            denoiser_kwargs=dict(filter_length=64,
                                                 n_overlap=4, win_length=64,
                                                 n_frames=16))
    srv = make_server(den_synth, slots=2, chunk_steps=8, max_text_len=96)
    wavs = list(srv.run([TEXTS[0], TEXTS[0]], seeds=[5, 5],
                        denoiser_strengths=[0.0, 0.3]).values())
    delta = (float(np.abs(wavs[0][: wavs[1].size] - wavs[1]).max())
             if wavs[1].size else 0.0)
    print(f"per-request denoiser: raw vs strength-0.3 sessions in ONE batch "
          f"(max sample delta {delta:.2e}, small on this few-step vocoder, "
          f"whose bias spectrum is near zero; "
          f"{srv.stats['denoiser_calls']} windowed-denoise calls)")
    print(f"launches {json.dumps(launch_counts())}")


if __name__ == "__main__":
    main()
