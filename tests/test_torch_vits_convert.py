"""VITS checkpoints into the port (``convert.vits_module_from_torch``) and
the benchmark cell's files.

An upstream-named ``SynthesizerTrn`` state dict, with the training-only
leaves (``enc_q.*``, ``dp.post_*``, ConvFlow_1), loads; its folded weight
norm equals the reference's ``fold``; a key the model does not read, or a
missing one, raises.  The cell ``vits-offline-b32``'s workload,
configuration and metric files keep to ``perfbench/harness.py``'s
contract, its readers read a synthetic observation, and a small run of
the cell on the CPU is correct, and not correct once the program's
output is disturbed."""

import copy
import json
import os
import time

import pytest
import torch

from perfbench import harness, roofline_vits, weights_vits
from perfbench.reference import vits as ref
from perfbench.trace import Observation
from text2speech_tpu_torch import convert
from text2speech_tpu_torch.config import VitsConfig
from text2speech_tpu_torch.models import vits as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json"),
                       encoding="utf-8"))
CELL = "vits-offline-b32"
METRICS = ["latent_ms.vits", "generator_ms.vits", "generator_roofline.vits",
           "pad_share.vits"]
# the offline cell's readers, which read this cell's spans and info as well
SHARED = ["mfu.offline", "idle_share.offline"]


def small_cfg() -> dict:
    cfg = copy.deepcopy(harness.load_cell(CELL)[1])
    cfg["vits"].update(hidden_channels=32, inter_channels=16,
                       filter_channels=48, dp_filter_channels=32,
                       upsample_initial_channel=32, n_layers=2)
    return cfg


def f32_module(sd, vc: VitsConfig) -> port.Vits:
    """The loader's module with the generator left in float32 (the
    loader casts it to bf16; the weights are then rounded)."""
    model = port.Vits(vc, "cpu")
    model.load_state_dict(convert.vits_state_dict(sd, vc))
    return model.eval()


@pytest.fixture(scope="module")
def upstream():
    cfg = small_cfg()
    sd = weights_vits.make_weights(cfg, 2 ** 31 + 9, "cpu", training=True)
    return cfg["vits"], sd, VitsConfig.from_dict(cfg["vits"])


def test_training_only_keys_are_skipped(upstream):
    v, sd, vc = upstream
    assert any(k.startswith("enc_q.") for k in sd)
    assert any(k.startswith("dp.post_") for k in sd)
    assert any(k.startswith("dp.flows.1.") for k in sd)
    model = convert.vits_module_from_torch(sd, vc, "cpu")
    inference = ref.vits_shapes(v)
    assert set(inference) < set(sd)
    assert model.dec.pre_w.dtype == torch.bfloat16
    assert model.enc.emb.dtype == torch.float32
    assert torch.equal(model.enc.emb, sd["enc_p.emb.weight"])
    a = "enc_p.encoder.attn_layers.1"
    assert torch.equal(model.enc.layers[1].qkv_w[32:64],
                       sd[f"{a}.conv_k.weight"][:, :, 0])
    assert torch.equal(model.enc.layers[1].rel_v, sd[f"{a}.emb_rel_v"][0])
    # ConvFlow_(j + 2) of upstream's list is the port's flows[j]
    assert torch.equal(model.dp.flows[0].proj_w,
                       sd["dp.flows.3.proj.weight"][:, :, 0])
    assert torch.equal(model.dp.flows[2].convs.ln_g[1, 1],
                       sd["dp.flows.7.convs.norms_2.1.gamma"])
    assert torch.equal(model.flows[3].post_w,
                       sd["flow.flows.6.post.weight"][:, :, 0])


@pytest.mark.parametrize("name", [
    "flow.flows.2.enc.in_layers.3", "flow.flows.0.enc.res_skip_layers.3",
    "dec.ups.0", "dec.ups.3", "dec.resblocks.4.convs1.2",
    "dec.resblocks.11.convs2.0"])
def test_folded_weight_norm_equals_the_reference(upstream, name):
    _, sd, _ = upstream
    got = convert._folded(sd, name)
    want = ref.fold(sd, name)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_fold_lands_in_the_module(upstream):
    _, sd, vc = upstream
    model = f32_module(sd, vc)
    torch.testing.assert_close(model.flows[1].in_w[2],
                               ref.fold(sd, "flow.flows.2.enc.in_layers.2"))
    torch.testing.assert_close(model.dec.up_w[1], ref.fold(sd, "dec.ups.1"))
    torch.testing.assert_close(model.dec.res_w[5][4],
                               ref.fold(sd, "dec.resblocks.5.convs2.1"))


def test_plain_weights_fold_back_to_themselves(upstream):
    """A checkpoint after ``remove_weight_norm`` holds ``weight``."""
    v, sd, vc = upstream
    plain = {k: t for k, t in sd.items() if not k.endswith(("weight_v",
                                                             "weight_g"))}
    for k in sd:
        if k.endswith("weight_v"):
            n = k[: -len(".weight_v")]
            plain[f"{n}.weight"] = ref.fold(sd, n)
    a, b = f32_module(sd, vc), f32_module(plain, vc)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(ta, tb, rtol=1e-5, atol=1e-6)


def test_odd_or_missing_keys_raise(upstream):
    _, sd, vc = upstream
    with pytest.raises(ValueError, match="emb_g"):
        convert.vits_module_from_torch(
            dict(sd, **{"emb_g.weight": torch.zeros(2, 4)}), vc, "cpu")
    with pytest.raises(KeyError):
        convert.vits_module_from_torch(
            {k: t for k, t in sd.items() if k != "dec.conv_post.weight"},
            vc, "cpu")


def test_another_symbol_table_raises(upstream):
    """A published checkpoint (LJSpeech's 178 symbols) names the table."""
    _, sd, vc = upstream
    emb = torch.zeros(178, sd["enc_p.emb.weight"].shape[1])
    with pytest.raises(ValueError, match="symbol table"):
        convert.vits_module_from_torch(
            dict(sd, **{"enc_p.emb.weight": emb}), vc, "cpu")


def test_upstream_checkpoint_file(tmp_path, upstream):
    _, sd, _ = upstream
    path = tmp_path / "G_100.pth"
    torch.save({"model": sd, "iteration": 100, "learning_rate": 2e-4},
               path)
    got = convert.load_torch_checkpoint(str(path))
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_config_reads_upstream_blocks():
    cfg = VitsConfig.from_dict({
        "train": {"batch_size": 64},
        "data": {"sampling_rate": 22050, "add_blank": True,
                 "n_speakers": 0},
        "model": {"inter_channels": 192, "upsample_rates": [8, 8, 2, 2],
                  "resblock_dilation_sizes": [[1, 3, 5]] * 3,
                  "use_spectral_norm": False}})
    assert cfg == VitsConfig() and cfg.hop == 256
    assert hash(cfg) == hash(VitsConfig())


# ---------------------------------------------------------------------------
# the benchmark cell's files
# ---------------------------------------------------------------------------


def test_the_cell_keeps_to_the_harness_contract():
    cell, cfg = harness.load_cell(CELL)
    assert cell["config"] == cfg["name"] == "vits-ljs"
    assert cell["chips"] == 1 and cell["traffic"] == "offline_vits"
    assert os.path.isfile(os.path.join(ROOT, "perfbench", "traffic",
                                       "offline_vits.py"))
    entry = next(c for c in BENCH["configs"] if c["name"] == "vits-ljs")
    assert entry["reduced"] == cfg["reduced"] == ["n_vocab"]
    assert entry["file"] == "perfbench/configs/vits-ljs.json"
    # every width as ljs_base.json has it; only the vocabulary differs
    assert VitsConfig.from_dict(cfg["vits"]) == VitsConfig()
    assert cfg["vits"]["n_vocab"] == 80
    e2e, layer = harness.cell_metrics(CELL, BENCH)
    assert {m["name"] for m in e2e} == {"audio_s_per_s", "setup_s"}
    assert [m["name"] for m in layer] == SHARED + METRICS
    for m in layer:
        assert m["moves"] == "audio_s_per_s"
        assert m["workloads"] == ([CELL] if m["name"] in METRICS
                                  else ["wg512-offline-b32", CELL])
        src = open(os.path.join(ROOT, "perfbench", "metrics",
                                f"{m['name']}.py"), encoding="utf-8").read()
        assert "def read(obs)" in src
    w = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert w["why"] == cell["why"] and len(w["why"]) <= 200


def test_the_readers_read_a_synthetic_observation():
    obs = Observation()
    for name in SHARED + METRICS:
        assert harness.read_metric(name, obs) is None
    obs.spans = [("batch", 1.0, 1.5), ("text_to_latent", 1.0, 1.05),
                 ("latent_to_audio", 1.05, 1.45), ("batch", 2.0, 2.5),
                 ("text_to_latent", 2.0, 2.03),
                 ("latent_to_audio", 2.03, 2.43)]
    obs.slice_s = (0.9, 2.6)
    obs.ops = [("conv", 1.06e6, 3e5), ("lrelu", 1.4e6, 4e4),
               ("gemm", 1.01e6, 1e4), ("conv", 2.1e6, 3e5)]
    obs.counters = {"vits.frames": [(1.02, 400), (2.01, 500), (3.0, 7)],
                    "vits.frames_padded": [(1.02, 1000), (2.01, 1000)]}
    obs.info = {"batch_flops": [1e13, 1e13], "generator_bound_s": [0.1, 0.2]}
    got = {n: harness.read_metric(n, obs) for n in SHARED + METRICS}
    assert got["latent_ms.vits"] == pytest.approx(40.0)
    assert got["generator_ms.vits"] == pytest.approx(400.0)
    assert got["generator_roofline.vits"] == pytest.approx(
        100 * 0.3 / 0.64)
    assert got["pad_share.vits"] == pytest.approx(55.0)
    assert got["mfu.offline"] == pytest.approx(100 * 2e13 / (1.0 * 989e12))
    assert got["idle_share.offline"] == pytest.approx(
        100 * (1 - 0.65 / 1.7))


def test_generator_counts():
    v = harness.load_cell(CELL)[1]["vits"]
    convs = roofline_vits.generator_convs(v, 1, 1)
    # conv_pre, 4 x (transposed conv + 3 resblocks x 6 convs), conv_post
    assert len(convs) == 2 + 4 * (1 + 18)
    per_frame = sum(o for o, _ in convs)
    assert per_frame * 22050 / 256 == pytest.approx(52.96e9, rel=1e-3)
    assert roofline_vits.generator_convs(v, 32, 100)[1][0] == \
        32 * 100 * 2 * 512 * 256 * 16
    assert [o for o, _ in roofline_vits.generator_convs(v, 2, 64)] == \
        [2 * o for o, _ in roofline_vits.generator_convs(v, 1, 64)]
    # conv_pre's bytes: its input, output, weights and bias in bf16
    assert convs[0][1] == 2 * (192 + 512 + 512 * 192 * 7 + 512)
    assert roofline_vits.generator_bound_s(v, 1, 64) < \
        roofline_vits.generator_bound_s(v, 2, 64) < \
        2 * roofline_vits.generator_bound_s(v, 1, 64)


def _small_run(**kw):
    cell, _ = harness.load_cell(CELL)
    cell = copy.deepcopy(cell)
    cell["params"].update(batch=3, check_rows=2, warm_frames=[64, 128],
                          max_frames=1024, syllables={"median": 5,
                                                      "sigma": 0.5, "min": 2,
                                                      "max": 9})
    ctx = harness.Context(CELL, cell, small_cfg(), 2 ** 31 + 77, 1.0, False,
                          time.perf_counter(), device="cpu", **kw)
    return harness.run_cell(ctx)


def _correct(out) -> bool:
    return out.failed == 0 and all(v <= lim for v, lim in
                                   out.checks.values())


def test_a_small_run_of_the_cell_is_correct():
    out = _small_run()
    assert _correct(out), out.checks
    assert set(out.checks) == {"logw_gap", "latent_gap", "audio_nsr"}
    assert out.attempted % 3 == 0 and out.e2e["audio_s_per_s"] > 0
    assert len(out.obs.info["generator_bound_s"]) == out.notes["batches"]


@pytest.mark.parametrize("fault", ["durations", "latent", "audio"])
def test_a_disturbed_run_is_not_correct(monkeypatch, fault):
    """Each check sees its own part: logw, the flows' output, the
    generator's output, disturbed by 1%, 1% and 10%
    (a noise-to-signal power of 1e-2)."""
    if fault == "durations":
        inner = port.DurationPredictor.forward
        monkeypatch.setattr(port.DurationPredictor, "forward",
                            lambda self, *a: inner(self, *a) * 1.01)
    elif fault == "latent":
        inner = port.Vits.flow_reverse
        monkeypatch.setattr(port.Vits, "flow_reverse",
                            lambda self, *a: inner(self, *a) * 1.01)
    else:
        inner = port.Generator.forward
        monkeypatch.setattr(port.Generator, "forward",
                            lambda self, z: inner(self, z) + 0.1 * inner(
                                self, z).roll(1, -1))
    out = _small_run()
    assert not _correct(out)
    gap = {"durations": "logw_gap", "latent": "latent_gap",
           "audio": "audio_nsr"}[fault]
    assert out.checks[gap][0] > out.checks[gap][1]
