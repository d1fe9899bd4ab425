"""The port's CLIs take every flag of the JAX package's.

Each option string of root ``train.py``, ``waveglow_train.py``,
``inference.py``, ``waveglow_inference.py`` and ``mel2samp.py`` is read
from their ``add_argument`` calls with ``ast`` (no JAX import), given a
value its type accepts, and parsed by the port's parser
(``text2speech_tpu_torch.tacotron_train``, ``.waveglow_train``,
``.inference``, ``.waveglow_inference``, ``.mel2samp``), one at a time (with
the script's required options) and all together: a command line of the JAX
CLI parses under the port instead of exiting with code 2."""

import argparse
import ast
from pathlib import Path

import pytest

from text2speech_tpu_torch import (inference, mel2samp, tacotron_train,
                                   waveglow_inference, waveglow_train)

REPO = Path(__file__).resolve().parent.parent
PORTS = {"train.py": tacotron_train.build_parser,
         "waveglow_train.py": waveglow_train.build_parser,
         "inference.py": inference.build_parser,
         "waveglow_inference.py": waveglow_inference.build_parser,
         "mel2samp.py": mel2samp.build_parser}
VALUES = {"int": "2", "float": "0.5", "str2bool": "false", "str": "x"}


def reference_options(script: str, required_only: bool = False) -> list:
    """[(option string, value or None for a flag)] of every
    ``add_argument`` call in ``script`` (with ``required_only``, of those
    with ``required=True``)."""
    tree = ast.parse((REPO / script).read_text(encoding="utf-8"))
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if required_only and not (isinstance(kw.get("required"),
                                             ast.Constant)
                                  and kw["required"].value is True):
            continue
        if "action" in kw and kw["action"].value in ("store_true",
                                                     "store_false"):
            value = None
        elif "choices" in kw:
            value = kw["choices"].elts[-1].value
        elif "type" in kw:
            value = VALUES[kw["type"].id]
        else:
            value = "x"
        out += [(a.value, value) for a in node.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return out


def _argv(options) -> list:
    argv = []
    for opt, value in options:
        argv += [opt] if value is None else [opt, value]
    return argv


CASES = [(script, opt, value) for script in PORTS
         for opt, value in reference_options(script)]


def test_the_reference_parsers_were_read():
    """The walk found the flags (train.py's --wav_dir among them)."""
    tacotron = dict(reference_options("train.py"))
    assert len(tacotron) >= 15 and "--wav_dir" in tacotron
    assert {"-c", "--config", "--grad_accum"} <= set(
        dict(reference_options("waveglow_train.py")))


@pytest.mark.parametrize("script,opt,value", CASES,
                         ids=[f"{s}:{o}" for s, o, _ in CASES])
def test_each_reference_flag_parses(script, opt, value):
    required = [(o, v) for o, v in reference_options(script, True)
                if o != opt]
    PORTS[script]().parse_args(_argv(required + [(opt, value)]))


@pytest.mark.parametrize("script", sorted(PORTS))
def test_a_command_line_of_every_reference_flag_parses(script):
    args = PORTS[script]().parse_args(_argv(reference_options(script)))
    assert isinstance(args, argparse.Namespace)


def test_wav_dir_is_accepted_and_unused():
    """``--wav_dir`` keeps ``train.py``'s default and changes nothing the
    trainer reads."""
    p = tacotron_train.build_parser()
    assert p.parse_args([]).wav_dir == "./wav/"
    a = vars(p.parse_args(["--wav_dir", "elsewhere"]))
    b = vars(p.parse_args([]))
    assert {k for k in a if a[k] != b[k]} == {"wav_dir"}


def test_the_inference_parsers_were_read():
    """Root ``inference.py``'s walk found ``--plot_dir`` and its one
    required option; the vocoder CLIs' required options too."""
    opts = dict(reference_options("inference.py"))
    assert len(opts) >= 20 and "--plot_dir" in opts
    assert [o for o, _ in reference_options("inference.py", True)] == [
        "--taco_checkpoint"]
    assert {o for o, _ in reference_options("waveglow_inference.py",
                                            True)} == {
        "-f", "--filelist_path", "-w", "--waveglow_checkpoint", "-o",
        "--output_dir"}
    assert {o for o, _ in reference_options("mel2samp.py", True)} == {
        "-f", "--filelist_path", "-o", "--output_dir"}


def test_plot_dir_keeps_the_root_default():
    """``--plot_dir`` defaults to None (no plots), as root
    ``inference.py``'s."""
    p = inference.build_parser()
    assert p.parse_args(["--random_init", "0"]).plot_dir is None
    assert p.parse_args(["--random_init", "0", "--plot_dir",
                         "d"]).plot_dir == "d"
