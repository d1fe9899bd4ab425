"""The CUDA-graph replay of the decoder's steps and the encoder's BiLSTM
(``utils/cuda_graphs.py``; ``Decoder.run_steps``, ``BiLSTM.forward``) on
the CPU at tiny widths.  The replays themselves run only on the card
(``tests/test_torch_cuda.py``); here:

* off the card, or with autograd on, ``run_steps`` and ``BiLSTM.forward``
  are their eager loops (``run_steps_eager``, ``forward_eager``, which the
  JAX parity tests pin), capture nothing and count nothing;
* ``usable`` engages only on contiguous CUDA tensors with autograd off, no
  capture in progress and no cached autocast;
* ``graph_key`` tells apart shapes, mask or none, the TF32 flags, autocast,
  inference mode and a moved parameter, and not an in-place weight load;
* ``GraphCache`` captures once a key, keeps the eight most recent, and its
  module's copies start empty;
* the block schedule of ``run_steps`` (blocks of ``MASK_BLOCK`` steps, a
  shorter tail of its own, the carry left in the static inputs between
  blocks) and the BiLSTM's static ``lengths``, run over a CPU stand-in for
  ``Graph`` that keeps the same static buffers, equal the eager loops bit
  for bit."""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2speech_tpu.ops import lstm as jlstm
from text2speech_tpu_torch.config import HParams
from text2speech_tpu_torch.models.tacotron2 import (MASK_BLOCK, Decoder,
                                                    Tacotron2,
                                                    sequence_mask)
from text2speech_tpu_torch.ops import lstm as tlstm
from text2speech_tpu_torch.utils import cuda_graphs
from text2speech_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

HP = HParams(
    embedding_size=16, enc_conv_num_layers=1, enc_conv_channels=16,
    attention_rnn_dim=16, decoder_rnn_dim=16, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=8, n_mel_channels=8, postnet_embedding_dim=8,
    postnet_n_convolutions=2, max_decoder_steps=40)
COUNTERS = ("taco.graph_captures", "taco.graph_replays")


def decoder_case(B=3, T_in=7, steps=5, seed=0, with_mask=True):
    """(decoder, (carry, keep_masks, memory, processed_memory, mask))."""
    torch.manual_seed(seed)
    dec = Decoder(HP)
    with torch.no_grad():
        dec.gate_proj.bias.fill_(-1.0)       # some rows stop, some do not
    memory = torch.randn(B, T_in, HP.enc_conv_channels)
    lengths = torch.randint(1, T_in + 1, (B,))
    mask = sequence_mask(lengths, T_in) if with_mask else None
    keep = torch.rand(steps, 2, B, HP.prenet_dim) < 0.5
    with torch.no_grad():
        pmem = dec.attention.process_memory(memory)
    return dec, (dec.initial_carry(memory), keep, memory, pmem, mask)


def flat(out) -> list:
    """run_steps' result as a flat list of tensors."""
    (state, frame, finished), *rest = out
    return [*state, frame, finished, *rest]


def assert_equal(got, want):
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_mask", [True, False])
def test_run_steps_off_the_card_is_the_eager_loop(grad, with_mask):
    dec, args = decoder_case(with_mask=with_mask)
    with torch.set_grad_enabled(grad), recording() as rec:
        got = dec.run_steps(*args)
        want = dec.run_steps_eager(*args)
    assert_equal(got, want)
    assert not set(COUNTERS) & set(rec.counters)
    assert len(dec._graphs) == 0


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_bilstm_off_the_card_is_the_eager_loop(grad, with_lengths):
    torch.manual_seed(1)
    mod = tlstm.BiLSTM(6, 5)
    xs = torch.randn(3, 9, 6)
    lengths = torch.tensor([9, 4, 1]) if with_lengths else None
    with torch.set_grad_enabled(grad), recording() as rec:
        got = mod(xs, lengths)
        want = mod.forward_eager(xs, lengths)
    assert torch.equal(got, want)
    assert not set(COUNTERS) & set(rec.counters)
    assert len(mod._graphs) == 0


def test_run_steps_calls_the_eager_loop(monkeypatch):
    """Off the card ``run_steps`` hands its arguments to
    ``run_steps_eager`` as they are, and returns what it returns."""
    dec, args = decoder_case()
    seen = []
    sentinel = object()

    def spy(self, *a):
        seen.append(a)
        return sentinel

    monkeypatch.setattr(Decoder, "run_steps_eager", spy)
    assert dec.run_steps(*args) is sentinel
    assert len(seen) == 1 and all(x is y for x, y in zip(seen[0], args))


def _dense_sd(tree):
    return {"weight": torch.from_numpy(np.asarray(tree["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.array(tree["bias"]))}


@pytest.mark.parametrize("with_lengths", [True, False])
def test_bilstm_forward_eager_matches_jax(with_lengths):
    """The eager loop the graph captures is the one the JAX parity pins
    (``tests/test_torch_tacotron.py::test_bilstm_ragged_matches_jax``)."""
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 9, 6).astype(np.float32)
    lengths = np.asarray([9, 4, 1], np.int32)
    mod = jlstm.BiLSTM(5)
    jl = jnp.asarray(lengths) if with_lengths else None
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(xs), jl)
    want = np.asarray(mod.apply(v, jnp.asarray(xs), jl))
    port = tlstm.BiLSTM(6, 5)
    for d in ("fwd", "bwd"):
        p = v["params"][d]["LSTMCell_0"]
        getattr(port, d).ih.load_state_dict(_dense_sd(p["ih"]))
        getattr(port, d).hh.load_state_dict(_dense_sd(p["hh"]))
    with torch.inference_mode():
        got = port.forward_eager(
            torch.from_numpy(xs),
            torch.from_numpy(lengths) if with_lengths else None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class _OnCard:
    """What ``usable`` reads of a tensor on the card: ``t``'s shape and
    strides."""

    is_cuda = True

    def __init__(self, t):
        self.shape, self._stride = t.shape, t.stride()

    def stride(self):
        return self._stride


@pytest.mark.parametrize("t,want", [
    (torch.zeros(3, 4, 5), True),
    (torch.zeros(3, 5, 4).transpose(1, 2), True),     # the encoder's convs
    (torch.zeros(3, 1, 4)[:, :, :2].transpose(0, 1), False),
    (torch.zeros(6, 4)[::2], False),                  # gaps
    (torch.zeros(4, 1).expand(4, 3), False),          # overlaps
    (torch.zeros(1, 4, 1), True),
    (torch.zeros(()), True),
])
def test_dense(t, want):
    assert cuda_graphs.dense(t) is want


@pytest.mark.parametrize("case,want", [
    ("engages", True),
    ("grad on", False),
    ("on the cpu", False),
    ("not dense", False),
    ("capturing", False),
    ("cached autocast", False),
    ("uncached autocast", True),
])
def test_usable(monkeypatch, case, want):
    capturing = case == "capturing"
    autocast = "autocast" in case
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch, "is_autocast_enabled",
                        lambda device_type=None: autocast)
    monkeypatch.setattr(torch, "is_autocast_cache_enabled",
                        lambda: case == "cached autocast")
    tensors = [_OnCard(torch.zeros(2, 3)),
               _OnCard(torch.zeros(3, 2).t()),
               _OnCard(torch.zeros(4, 3)[::2] if case == "not dense"
                       else torch.zeros(2, 3))]
    if case == "on the cpu":
        tensors.append(torch.zeros(2))
    with torch.set_grad_enabled(case == "grad on"):
        assert cuda_graphs.usable(*tensors) is want


def _key_inputs(args):
    carry, keep, memory, pmem, mask = args
    tensors = [keep, *carry[0], *carry[1:], memory, pmem]
    return tensors + ([] if mask is None else [mask])


@pytest.mark.parametrize("change,differs", [
    ("values", False),
    ("in-place load", False),
    ("batch", True),
    ("block", True),
    ("encoder width", True),
    ("no mask", True),
    ("dtype", True),
    ("layout", True),
    ("tf32 matmul", True),
    ("tf32 cudnn", True),
    ("autocast", True),
    ("inference mode", True),
    ("moved parameter", True),
    ("assigned state", True),
])
def test_graph_key(change, differs):
    dec, args = decoder_case()
    base = cuda_graphs.graph_key(dec, _key_inputs(args))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        if change == "values":
            _, args = decoder_case(seed=5)
        elif change == "in-place load":
            sd = {k: v + 1 for k, v in dec.state_dict().items()}
            dec.load_state_dict(sd)
        elif change == "batch":
            _, args = decoder_case(B=4)
        elif change == "block":
            _, args = decoder_case(steps=6)
        elif change == "encoder width":
            _, args = decoder_case(T_in=8)
        elif change == "no mask":
            _, args = decoder_case(with_mask=False)
        elif change == "dtype":
            carry, keep, memory, pmem, mask = args
            args = (carry, keep, memory.double(), pmem, mask)
        elif change == "layout":
            carry, keep, memory, pmem, mask = args
            memory = memory.transpose(1, 2).contiguous().transpose(1, 2)
            args = (carry, keep, memory, pmem, mask)
        elif change == "tf32 matmul":
            torch.backends.cuda.matmul.allow_tf32 = not flags[0]
        elif change == "tf32 cudnn":
            torch.backends.cudnn.allow_tf32 = not flags[1]
        elif change == "moved parameter":
            dec.mel_proj.weight.data = dec.mel_proj.weight.data.clone()
        elif change == "assigned state":
            sd = {k: v.clone() for k, v in dec.state_dict().items()}
            dec.load_state_dict(sd, assign=True)
        if change == "autocast":
            with torch.autocast("cpu", dtype=torch.bfloat16):
                key = cuda_graphs.graph_key(dec, _key_inputs(args))
        elif change == "inference mode":
            with torch.inference_mode():
                key = cuda_graphs.graph_key(dec, _key_inputs(args))
        else:
            key = cuda_graphs.graph_key(dec, _key_inputs(args))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert (key != base) is differs


class StandIn:
    """``cuda_graphs.Graph`` on the CPU: the same static inputs (copies of
    the capture's tensors, written by ``replay``), outputs that each replay
    overwrites in place, and a lock; ``fn`` runs eagerly at every
    replay."""

    captured = []

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = [torch.empty_strided(t.shape, t.stride(),
                                           dtype=t.dtype).copy_(t)
                       for t in inputs]
        self.lock = threading.Lock()
        self.outputs = None
        StandIn.captured.append(self)

    def replay(self, *inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        new = self.fn(*self.inputs)
        if self.outputs is None:
            self.outputs = new
        elif isinstance(new, torch.Tensor):
            self.outputs.copy_(new)
        else:
            for o, n in zip(self.outputs, new):
                o.copy_(n)
        return self.outputs


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs engage on the CPU, each one a :class:`StandIn`."""
    StandIn.captured = []
    monkeypatch.setattr(cuda_graphs, "Graph", StandIn)
    monkeypatch.setattr(cuda_graphs, "usable", lambda *t: True)
    return StandIn


@pytest.mark.parametrize("steps,blocks", [
    (5, [5]),
    (MASK_BLOCK, [MASK_BLOCK]),
    (2 * MASK_BLOCK + 22, [MASK_BLOCK, MASK_BLOCK, 22]),
])
@pytest.mark.parametrize("with_mask", [True, False])
def test_block_schedule_equals_the_eager_loop(stand_in, steps, blocks,
                                              with_mask):
    dec, args = decoder_case(B=2, steps=steps, with_mask=with_mask)
    with torch.inference_mode():
        want = dec.run_steps_eager(*args)
        with recording() as rec:
            got = dec.run_steps(*args)
            again = dec.run_steps(*args)
    assert_equal(got, want)
    assert_equal(again, want)
    n_graphs = len(set(blocks))
    assert len(stand_in.captured) == n_graphs == len(dec._graphs)
    assert [v for _, v in rec.counters["taco.graph_captures"]] == \
        [1] * n_graphs
    assert [v for _, v in rec.counters["taco.graph_replays"]] == \
        [len(blocks)] * 2
    assert [g.inputs[0].shape[0] for g in stand_in.captured] == \
        sorted(set(blocks), reverse=True)
    # the outputs are copies: a later replay leaves them alone
    assert not any(o.data_ptr() == s.data_ptr() for o in flat(got)
                   for g in stand_in.captured for s in g.inputs)


def test_chunked_decode_equals_the_whole_decode(stand_in):
    """Chunks of ``decode_chunk`` from the returned carry equal one whole
    decode, as the eager loop's do."""
    torch.manual_seed(2)
    taco = Tacotron2(HP, n_vocab=20)
    ids = torch.randint(1, 20, (2, 6))
    lengths = torch.tensor([6, 3])
    steps, chunk = 40, 16
    keep = torch.rand(steps, 2, 2, HP.prenet_dim) < 0.5
    with torch.inference_mode():
        memory = taco.encode(ids, text_lengths=lengths)
        whole = taco.decoder.run_steps_eager(
            taco.decoder.initial_carry(memory), keep, memory,
            taco.process_memory(memory), sequence_mask(lengths, 6))
        carry, mels = taco.decoder.initial_carry(memory), []
        for t0 in range(0, steps, chunk):
            carry, mel, *_ = taco.decode_chunk(
                memory, *carry, keep[t0:t0 + chunk], lengths)
            mels.append(mel)
    assert torch.equal(torch.cat(mels, 2)[..., :steps], whole[1].float())
    assert [tuple(g.inputs[0].shape[:1]) for g in stand_in.captured
            if len(g.inputs) > 2] == [(16,), (8,)]


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_bilstm_replay_equals_the_eager_loop(stand_in, with_lengths,
                                             transposed):
    """Also on the encoder convs' layout ([B, T, C] as a transpose of
    [B, C, T]), which the static input keeps."""
    torch.manual_seed(1)
    mod = tlstm.BiLSTM(6, 5)
    with torch.inference_mode(), recording() as rec:
        for lens in ([9, 4, 1], [2, 9, 5]):
            xs = (torch.randn(3, 6, 9).transpose(1, 2) if transposed
                  else torch.randn(3, 9, 6))
            lengths = torch.tensor(lens) if with_lengths else None
            assert torch.equal(mod(xs, lengths),
                               mod.forward_eager(xs, lengths))
    assert len(stand_in.captured) == 1
    assert stand_in.captured[0].inputs[0].stride() == xs.stride()
    assert [v for _, v in rec.counters["taco.graph_replays"]] == [1, 1]


def test_cache_captures_once_a_key_and_keeps_the_newest(stand_in):
    cache = cuda_graphs.GraphCache("taco.graph_captures")
    x = torch.zeros(1)
    with recording() as rec:
        first = [cache.get(k, lambda t: t, [x]) for k in range(10)]
        assert cache.get(9, None, [x]) is first[9]
        # 0 went first; its capture now makes 2 the least recently used
        assert cache.get(0, lambda t: t, [x]) is not first[0]
        assert cache.get(3, None, [x]) is first[3]
        assert cache.get(2, lambda t: t, [x]) is not first[2]
    assert len(cache) == cuda_graphs.CACHE_SIZE
    assert len(rec.counters["taco.graph_captures"]) == 12


def test_a_copy_of_a_module_starts_with_no_graphs(stand_in):
    dec, args = decoder_case()
    with torch.inference_mode():
        dec.run_steps(*args)
    assert len(dec._graphs) == 1
    twin = copy.deepcopy(dec)
    assert len(twin._graphs) == 0 and twin._graphs is not dec._graphs
    assert twin._graphs.counter == dec._graphs.counter


def test_threads_share_a_graph_one_at_a_time(stand_in):
    """Eight threads decode their own inputs through one captured graph
    (two blocks and a tail each) with the interpreter switching threads
    every microsecond: each gets its own eager result, and the key is
    captured once.  Without the graph's lock one thread's static inputs
    would be overwritten by another's between its copy and its replay."""
    import sys

    dec, _ = decoder_case(B=2, steps=1)
    cases = [decoder_case(B=2, steps=2 * MASK_BLOCK + 5, seed=s)[1]
             for s in range(8)]
    with torch.inference_mode():
        want = [dec.run_steps_eager(*args) for args in cases]
    got, errors = [None] * len(cases), []

    def work(i):
        try:
            with torch.inference_mode():
                for _ in range(2):
                    got[i] = dec.run_steps(*cases[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert len(stand_in.captured) == 2           # a 64-step block, a tail
