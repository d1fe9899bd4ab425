"""``python -m text2speech_tpu_torch.convert_checkpoint`` on the CPU
(``--device cpu``) at a tiny configuration: it writes the port's training
checkpoint (``ckpt_00000000.pt``: the converted weights at step 0, a fresh
optimizer), which the port's ``inference`` CLI serves as it serves a
trained one and the trainers' restore reads unchanged; it prints the JAX
CLI's parameter count (counted from the JAX ``tacotron_from_torch`` /
``waveglow_from_torch`` trees: the root CLI's count is the leaves of its
state's params); and without a card it refuses to run unless ``--device
cpu`` is given."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_torch_tacotron_train import TINY
from text2speech_tpu import convert as jconvert
from text2speech_tpu.config import HParams as JaxHParams
from text2speech_tpu.config import WaveGlowConfig as JaxWaveGlowConfig
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import HParams, WaveGlowConfig
from text2speech_tpu_torch.examples.reference_checkpoints import (
    reference_tacotron_state_dict, reference_waveglow_state_dict)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = HParams(**TINY)
WG_BLOCKS = {
    "train_config": {"learning_rate": 1e-4, "sigma": 1.0},
    "data_config": {"sampling_rate": 22050, "hop_length": 16},
    "waveglow_config": {"n_mel_channels": 8, "n_flows": 5, "n_group": 8,
                        "n_early_every": 2, "n_early_size": 2,
                        "upsample_kernel": 64, "upsample_stride": 16,
                        "WN_config": {"n_layers": 3, "n_channels": 32,
                                      "kernel_size": 3}},
}


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return int(np.prod(tree.shape))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format checkpoints, the JSONs and the converted port
    checkpoints (one CLI process each)."""
    d = tmp_path_factory.mktemp("convert_cli")
    HP.save(str(d / "hp.json"))
    (d / "wg.json").write_text(json.dumps(WG_BLOCKS))
    cfg = WaveGlowConfig.from_json(str(d / "wg.json"))
    taco_sd = reference_tacotron_state_dict(HP, 2)
    wg_sd = reference_waveglow_state_dict(cfg, 3)
    torch.save({"iteration": 10, "state_dict": taco_sd,
                "learning_rate": 1e-3}, d / "taco.pt")
    torch.save(wg_sd, d / "wg.pt")
    out = {}
    for kind, src, flag, conf in (("tacotron", "taco.pt", "--hparams",
                                   "hp.json"),
                                  ("waveglow", "wg.pt", "--config",
                                   "wg.json")):
        r = subprocess.run(
            [sys.executable, "-m", "text2speech_tpu_torch.convert_checkpoint",
             "--kind", kind, "--torch_ckpt", str(d / src), "--out_dir",
             str(d / kind), flag, str(d / conf), "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        out[kind] = r.stdout
    return {"dir": d, "cfg": cfg, "taco_sd": taco_sd, "wg_sd": wg_sd,
            "stdout": out}


@pytest.mark.parametrize("kind", ["tacotron", "waveglow"])
def test_writes_the_port_checkpoint(files, kind):
    d = files["dir"]
    assert sorted(os.listdir(d / kind)) == ["ckpt_00000000.pt"]
    tree = torch.load(d / kind / "ckpt_00000000.pt", weights_only=True)
    assert tree["step"] == 0
    assert tree["opt_state"]["state"] == {}          # a fresh optimizer
    if kind == "tacotron":
        params, stats = convert.tacotron_from_torch(files["taco_sd"], HP)
        want = convert.tacotron_state_dict(
            {"params": params, "batch_stats": stats}, HP)
        saved = {**tree["params"], **tree["batch_stats"]}
        want = {k: v for k, v in want.items()
                if not k.endswith("num_batches_tracked")}
    else:
        flat = convert.flatten_tree(
            convert.waveglow_from_torch(files["wg_sd"], files["cfg"]))
        want = {k: torch.from_numpy(v) for k, v in flat.items()}
        saved = tree["params"]
    assert set(saved) == set(want)
    for k in want:
        assert torch.equal(saved[k], want[k]), k


def test_printed_count_is_the_jax_clis(files):
    """The root CLI prints the leaves of its state's params: the JAX
    ``tacotron_from_torch`` params (not the batch statistics) and the
    ``waveglow_from_torch`` tree."""
    jtaco, _ = jconvert.tacotron_from_torch(files["taco_sd"],
                                            JaxHParams(**TINY))
    jwg = jconvert.waveglow_from_torch(
        files["wg_sd"], JaxWaveGlowConfig.from_json(
            str(files["dir"] / "wg.json")))
    for kind, tree in (("tacotron", jtaco), ("waveglow", jwg)):
        line = files["stdout"][kind].strip()
        m = re.fullmatch(r"converted (\S+) -> (\S+) \(([\d,]+) params\)",
                         line)
        assert m, line
        assert int(m[3].replace(",", "")) == _n_params(tree)
        assert m[2] == str(files["dir"] / kind)


def test_inference_cli_serves_the_converted_checkpoints(files, tmp_path):
    """``inference --device cpu --taco_checkpoint --waveglow_checkpoint``
    on the converted directories writes the WAV that a ``Synthesizer`` of
    the module conveniences (``tacotron_module_from_torch`` /
    ``waveglow_module_from_torch``) synthesizes: equal PCM16."""
    from text2speech_tpu_torch import inference
    from text2speech_tpu_torch.dsp.audio import save_wav
    from text2speech_tpu_torch.infer import Synthesizer

    d, cfg = files["dir"], files["cfg"]
    out = str(tmp_path / "cli.wav")
    inference.main([
        "--taco_checkpoint", str(d / "tacotron"),
        "--waveglow_checkpoint", str(d / "waveglow"), "--hparams",
        str(d / "hp.json"), "--waveglow_config", str(d / "wg.json"),
        "--text", "안녕하세요.", "--max_steps", "12", "--out", out,
        "--device", "cpu"])
    sr, got = wavfile.read(out)
    assert sr == 22050 and got.dtype == np.int16
    synth = Synthesizer(
        HP, convert.tacotron_module_from_torch(files["taco_sd"], HP), cfg,
        convert.waveglow_module_from_torch(files["wg_sd"], cfg),
        use_denoiser=False)
    mel, lengths = synth.text_to_mel(["안녕하세요."], max_steps=12)
    frames = int(lengths[0])
    assert frames == 12              # its gate bias of -10 never stops
    wav = synth.mel_to_audio(mel[:, :, :frames].contiguous(), 0.666)
    ref = str(tmp_path / "ref.wav")
    save_wav(wav[0].numpy(), ref, 22050)
    _, want = wavfile.read(ref)
    assert got.shape == (frames * cfg.upsample_stride,)
    np.testing.assert_array_equal(got, want)


def test_trainers_restore_the_converted_checkpoints(files):
    """The trainers' restore (``CheckpointManager.restore`` into their
    fresh states: ``create_tacotron_state`` of a ``Tacotron2``,
    ``create_train_state`` of a ``TrainableWaveGlow``'s parameters) reads
    the converted checkpoints unchanged."""
    from text2speech_tpu_torch.models.tacotron2 import Tacotron2
    from text2speech_tpu_torch.models.waveglow import TrainableWaveGlow
    from text2speech_tpu_torch.text import N_SYMBOLS
    from text2speech_tpu_torch.train.checkpoint import CheckpointManager
    from text2speech_tpu_torch.train.state import (create_tacotron_state,
                                                   create_train_state)

    d, cfg = files["dir"], files["cfg"]
    taco = Tacotron2(HP, n_vocab=N_SYMBOLS)
    state, step = CheckpointManager(str(d / "tacotron")).restore(
        create_tacotron_state(taco, HP))
    assert step == 0
    want = convert.tacotron_module_from_torch(files["taco_sd"], HP)
    for k, v in want.state_dict().items():
        assert torch.equal(taco.state_dict()[k], v), k
    wg = TrainableWaveGlow(cfg)
    state, step = CheckpointManager(str(d / "waveglow")).restore(
        create_train_state(wg.params, cfg.learning_rate))
    assert step == 0
    flat = convert.flatten_tree(convert.waveglow_from_torch(files["wg_sd"],
                                                            cfg))
    for name, p in wg.params.items():
        assert torch.equal(p.detach(), torch.from_numpy(flat[name])), name


def test_refuses_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    r = subprocess.run(
        [sys.executable, "-m", "text2speech_tpu_torch.convert_checkpoint",
         "--kind", "waveglow", "--torch_ckpt", str(tmp_path / "none.pt"),
         "--out_dir", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert not (tmp_path / "out").exists()


def test_refuses_a_vocabulary_the_port_cannot_encode(files, tmp_path):
    """A Tacotron whose embedding is not the port's symbol table (80
    symbols) cannot serve the port's text frontend: the CLI says so."""
    from text2speech_tpu_torch.convert_checkpoint import convert as run

    sd = dict(files["taco_sd"])
    sd["embedding.weight"] = sd["embedding.weight"][:40]
    torch.save({"state_dict": sd}, tmp_path / "small.pt")
    with pytest.raises(ValueError, match="40 symbols"):
        run("tacotron", str(tmp_path / "small.pt"), str(tmp_path / "o"),
            str(files["dir"] / "hp.json"), device="cpu")
