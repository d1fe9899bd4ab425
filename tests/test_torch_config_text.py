"""The port keeps its own copies of the JAX package's ``config`` and ``text``
modules (it imports nothing of that package).  These tests hold the copies
to the originals: same dataclass fields and defaults, same symbol table,
same ids and lengths for the strings the JAX package's own text tests use
(``tests/test_text.py``, ``tests/test_english.py`` and the golden file)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from text2speech_tpu import config as jcfg
from text2speech_tpu import text as jtext
from text2speech_tpu.text import cleaners as jcleaners
from text2speech_tpu.text import english as jenglish
from text2speech_tpu.text import korean as jkorean
from text2speech_tpu_torch import config as tcfg
from text2speech_tpu_torch import text as ttext
from text2speech_tpu_torch.text import cleaners as tcleaners
from text2speech_tpu_torch.text import english as tenglish
from text2speech_tpu_torch.text import korean as tkorean

GOLDEN = Path(__file__).parent / "golden" / "text_golden.json"

STRINGS = [
    "안녕하세요", "안녕 zz하세요", "존경하는 사람과 함께 갑니다", "안녕",
    "존경하는 사람.", "{HH AW}", "+5%", "안녕하세요가힣깎",
    "안녕하세요. 반갑습니다! 잘 지내시죠?",
    '그는 "간다. 지금 간다." 라고 말했다.',
    "Dr. Kim came. He left.", "See No. 5 below. Done.",
    "Dr. Smith bought 2 apples for $1.50!", "1,234 things", "in 1999",
    "the 3rd time", "café naïve", "",
]


def _golden_strings():
    with open(GOLDEN, encoding="utf-8") as f:
        golden = json.load(f)
    return sorted({s for section in golden.values() for s in section})


@pytest.mark.parametrize("name", ["HParams", "WaveGlowConfig"])
def test_config_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tc)]
    assert jf == tf
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())
    # derived properties the port's modules read
    for prop in ("n_remaining_channels",) if name == "WaveGlowConfig" else ():
        assert getattr(jc(), prop) == getattr(tc(), prop)


def test_config_loaders_agree(tmp_path):
    """``from_dict`` (legacy aliases included), ``load`` and ``from_json``
    build equal field values on both sides."""
    legacy = {"fft_size": 2048, "hop_size": 300, "num_mels": 40,
              "sample_rate": 16000}
    assert (dataclasses.asdict(jcfg.HParams.from_dict(legacy))
            == dataclasses.asdict(tcfg.HParams.from_dict(legacy)))
    p = tmp_path / "hp.json"
    p.write_text(json.dumps({"n_mel_channels": 40, "prenet_dim": 64}))
    assert (dataclasses.asdict(jcfg.HParams.load(str(p)))
            == dataclasses.asdict(tcfg.HParams.load(str(p))))
    w = tmp_path / "wg.json"
    w.write_text(json.dumps({"waveglow_config": {
        "n_mel_channels": 40, "n_flows": 6, "n_group": 8, "n_early_every": 2,
        "n_early_size": 2, "WN_config": {"n_layers": 4, "n_channels": 64,
                                          "kernel_size": 3}}}))
    assert (dataclasses.asdict(jcfg.WaveGlowConfig.from_json(str(w)))
            == dataclasses.asdict(tcfg.WaveGlowConfig.from_json(str(w))))
    assert (dataclasses.asdict(jcfg.DEFAULT_HPARAMS)
            == dataclasses.asdict(tcfg.DEFAULT_HPARAMS))


def test_symbol_tables_equal():
    import importlib

    jsym = importlib.import_module("text2speech_tpu.text.symbols")
    tsym = importlib.import_module("text2speech_tpu_torch.text.symbols")

    assert jtext.N_SYMBOLS == ttext.N_SYMBOLS
    assert list(jsym.symbols) == list(tsym.symbols)
    assert jsym.char_to_id == tsym.char_to_id
    assert (jsym.PAD, jsym.EOS) == (tsym.PAD, tsym.EOS)


def test_korean_dictionaries_equal():
    """The port opens its own copy of ``data/korean_dicts.json``."""
    jpath = Path(jkorean.__file__).parent / "data" / "korean_dicts.json"
    tpath = Path(tkorean.__file__).parent / "data" / "korean_dicts.json"
    assert jpath != tpath and tpath.is_file()
    assert json.loads(jpath.read_text("utf-8")) == json.loads(
        tpath.read_text("utf-8"))


def test_encode_batch_identical_over_the_text_tests_strings():
    texts = STRINGS + _golden_strings()
    jids, jlen = jtext.encode_batch(texts)
    tids, tlen = ttext.encode_batch(texts)
    assert jids.dtype == tids.dtype == np.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlen, jlen)
    # one by one as well: padding to the batch maximum hides nothing
    for s in texts:
        np.testing.assert_array_equal(ttext.text_to_sequence(s),
                                      jtext.text_to_sequence(s), s)
    jp, _ = jtext.encode_batch(["안녕"], pad_to=64)
    tp, _ = ttext.encode_batch(["안녕"], pad_to=64)
    np.testing.assert_array_equal(tp, jp)


def test_normalizers_and_cleaners_identical():
    for s in STRINGS + _golden_strings():
        assert tkorean.normalize(s) == jkorean.normalize(s), s
        assert tcleaners.english_cleaners(s) == jcleaners.english_cleaners(s)
        assert tenglish.normalize_numbers(s) == jenglish.normalize_numbers(s)
    seq = jtext.text_to_sequence("존경하는 사람.")
    assert ttext.sequence_to_text(seq) == jtext.sequence_to_text(seq)
    long = "안녕하세요. 반갑습니다! Dr. Kim came. He left."
    assert ttext.split_sentences(long) == jtext.split_sentences(long)
