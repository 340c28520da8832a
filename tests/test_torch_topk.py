"""The top-k select and the sparsifying codecs of the port against the
reference on the CPU.

* ``ref.topk_select_ref`` (the plain version the CUDA kernel is held
  against on the card) is bit-identical to ``repro.kernels.ref.
  topk_select_ref`` and to the Pallas kernel run in interpret mode, and
  keeps exactly k;
* ``topk:r`` and ``randk:r`` bill the reference's bytes and return the
  reference's ``(sent, residual)`` bit for bit over chained calls (rand-k
  is fed the reference's own index sets: threefry cannot be reproduced in
  torch); the error-feedback algebra is exact; an empty payload is a
  no-op;
* the ``topk_select`` dispatch table.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.fed import codecs as rcodecs  # noqa: E402
from repro.kernels import codec_ops as rcodec_ops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.fed import codecs  # noqa: E402
from repro_torch.kernels import codec_ops, ops, ref  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import ravel, tree_leaves, tree_map  # noqa: E402

# the (n, k) cases of tests/test_kernels.py, plus tile edges of the CUDA
# kernel (4096 elements a tile)
TOPK_CASES = [(8, 2), (35, 4), (1000, 100), (5000, 1), (2048, 2048),
              (1537, 700), (1024, 1), (4097, 1), (4097, 4097)]
TIE_VECTOR = [3.0, -1.0, 1.0, 1.0, -3.0, 1.0, 0.5, -1.0]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _check_select(x: np.ndarray, k: int, interpret: bool = True) -> np.ndarray:
    want = np.asarray(rref.topk_select_ref(jnp.asarray(x), k))
    got = ref.topk_select_ref(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if interpret:
        kern = np.asarray(rcodec_ops.topk_select(jnp.asarray(x), k,
                                                 interpret=True))
        np.testing.assert_array_equal(_bits(got), _bits(kern))
    return got


# ------------------------------------------------- the plain select
@pytest.mark.parametrize("n,k", TOPK_CASES)
def test_topk_plain_bit_identical_to_reference(n, k):
    x = np.random.default_rng(n + k).normal(size=n).astype(np.float32)
    got = _check_select(x, k)
    assert np.count_nonzero(got) == k


def test_topk_plain_threshold_ties():
    x = np.asarray(TIE_VECTOR, np.float32)
    for k in range(1, 9):
        got = _check_select(x, k)
        assert np.count_nonzero(got) == k


def test_topk_plain_at_the_main_path_size():
    """n = 2 * 206,922: the (g, Γ) payload of fim_lbfgs on the full
    F-MNIST CNN, k = ceil(0.1 n)."""
    n, k = 413_844, 41_385
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=n // 2) * 1e-2,
                        rng.exponential(size=n // 2) * 1e-4]).astype(np.float32)
    got = _check_select(x, k, interpret=False)
    assert np.count_nonzero(got) == k


def test_topk_plain_exact_and_signed_zeros():
    """Exact zeros and -0.0 share bucket 0; a kept -0.0 keeps its sign and
    every dropped entry is +0.0."""
    rng = np.random.default_rng(3)
    levels = np.asarray([0.0, -0.0, 1.0, -1.0, 1.25, 2.0], np.float32)
    x = levels[rng.integers(0, 6, size=5000)]
    for k in (1, 900, 2500, 4999, 5000):
        _check_select(x, k, interpret=k in (1, 5000))
    got = ref.topk_select_ref(torch.from_numpy(x), 5000).numpy()
    np.testing.assert_array_equal(np.signbit(got), np.signbit(x))


# ------------------------------------------------------- dispatch
def test_topk_dispatch_table():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=300)
                         .astype(np.float32))
    outs = [ops.topk_select(x, 30, mode=m) for m in ("auto", "off")]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], ref.topk_select_ref(x, 30))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.topk_select(x, 30, mode="on")
    for bad in (-1, 301):
        with pytest.raises(ValueError, match="k <= n"):
            ops.topk_select(x, bad)
    with pytest.raises(ValueError, match="CUDA"):
        codec_ops.topk_select(x, 30)
    assert codec_ops.topk_scratch_len(1) == codec_ops.TOPK_HEADER + 2
    assert (codec_ops.topk_scratch_len(413_844)
            == codec_ops.TOPK_HEADER + 2 * 102)


# ----------------------------------------------------------- codecs
def _payload(rng):
    """A (g, Γ)-shaped payload: a dict of leaves and a nonnegative twin."""
    g = {"conv0": {"w": rng.normal(size=(3, 3, 1, 4)).astype(np.float32),
                   "b": rng.normal(size=4).astype(np.float32) * 1e-3},
         "out": {"w": rng.normal(size=(6, 10)).astype(np.float32) * 0.1}}
    f = jax.tree.map(lambda a: np.abs(a) ** 2, g)
    return (g, f)


def test_codec_registry_wire_bytes_and_k_match_reference():
    assert codecs.names() == rcodecs.names() == ["int8", "none", "randk",
                                                  "topk"]
    for spec in ("topk", "topk:0.1", "topk:0.013", "topk:1.0", "randk:0.25",
                 "randk:1"):
        ours, theirs = codecs.make(spec), rcodecs.make(spec)
        assert ours.spec() == theirs.spec() and ours.ratio == theirs.ratio
        assert ours.sparsifying and ours.error_feedback and not ours.identity
        for n in (0, 1, 2, 7, 100, 1001, 27_930, 206_922, 413_844, 12.5):
            assert ours.wire_bytes(n) == theirs.wire_bytes(n)
            assert codecs.achieved_ratio(ours, n) == rcodecs.achieved_ratio(
                theirs, n)
            if float(n).is_integer():
                assert ours._k(int(n)) == theirs._k(int(n))
    assert codecs.make("topk:0.1")._k(413_844) == 41_385
    assert codecs.make("topk:0.1")._k(206_922) == 20_693


@pytest.mark.parametrize("spec", ["topk:0", "topk:-0.1", "topk:1.5",
                                  "randk:2", "topk:abc"])
def test_make_refuses_bad_ratios(spec):
    with pytest.raises(ValueError):
        rcodecs.make(spec)
    with pytest.raises(ValueError):
        codecs.make(spec)


def test_ravel_matches_jax_ravel_pytree():
    tree = _payload(np.random.default_rng(1))
    want, _ = jax.flatten_util.ravel_pytree(tree)
    flat, unravel = ravel(from_jax(tree))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat * 2)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(tree), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b) * 2)


def _chain(spec: str, calls: int = 3, feed_indices: bool = False):
    """``calls`` chained round-trips of fresh payloads with error feedback,
    the residual of one call handed to the next, on both packages."""
    rng = np.random.default_rng(11)
    ours, theirs = codecs.make(spec), rcodecs.make(spec)
    key = jax.random.PRNGKey(5)
    r_res = p_res = None
    for _ in range(calls):
        tree = _payload(rng)
        key, sub = jax.random.split(key)
        if feed_indices:
            flat, _ = jax.flatten_util.ravel_pytree(
                tree if r_res is None else jax.tree.map(jnp.add, tree, r_res))
            k = theirs._k(flat.size)
            idx = np.array(jax.random.choice(sub, flat.size, (k,),
                                               replace=False))
            ours.indices = lambda n, k, gen, idx=idx: torch.from_numpy(idx)
        r_sent, r_res = theirs.roundtrip(jax.tree.map(jnp.asarray, tree), sub,
                                         r_res)
        before = from_jax(tree) if p_res is None else tree_map(
            torch.add, from_jax(tree), p_res)
        p_sent, p_res = ours.roundtrip(from_jax(tree), torch.Generator(),
                                       p_res)
        for a, b in zip(tree_leaves(p_sent), jax.tree.leaves(r_sent),
                        strict=True):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        for a, b in zip(tree_leaves(p_res), jax.tree.leaves(r_res),
                        strict=True):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        # error feedback loses nothing: sent + residual == payload + old
        for s, r, b in zip(tree_leaves(p_sent), tree_leaves(p_res),
                           tree_leaves(before), strict=True):
            assert torch.equal(s + r, b)
        flat_sent, _ = ravel(p_sent)
        assert int(torch.count_nonzero(flat_sent)) == ours._k(
            flat_sent.numel())


def test_topk_roundtrip_bit_identical_to_reference_over_chained_calls():
    _chain("topk:0.1")
    _chain("topk:0.37")


def test_randk_roundtrip_bit_identical_with_the_reference_indices():
    _chain("randk:0.1", feed_indices=True)


def test_randk_draws_k_distinct_indices_from_the_generator():
    codec = codecs.make("randk:0.2")
    idx = codec.indices(50, 10, torch.Generator().manual_seed(0))
    assert idx.shape == (10,) and len(set(idx.tolist())) == 10
    again = codec.indices(50, 10, torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
    x = torch.arange(1.0, 51.0)
    sent, res = codec.roundtrip({"a": x}, torch.Generator().manual_seed(0))
    assert int(torch.count_nonzero(sent["a"])) == 10
    assert torch.equal(sent["a"] + res["a"], x)


@pytest.mark.parametrize("spec", ["topk:0.1", "randk:0.1"])
def test_empty_payload_is_a_noop(spec):
    tree = {"a": torch.zeros((0,)), "b": torch.zeros((0, 3))}
    sent, res = codecs.make(spec).roundtrip(tree, torch.Generator())
    r_sent, r_res = rcodecs.make(spec).roundtrip(
        {"a": jnp.zeros((0,)), "b": jnp.zeros((0, 3))}, jax.random.PRNGKey(0))
    assert sent is tree
    for a, b in zip(tree_leaves(res), jax.tree.leaves(r_res), strict=True):
        assert tuple(a.shape) == b.shape and a.numel() == 0
    assert codecs.make(spec)._k(0) == rcodecs.make(spec)._k(0) == 0
    assert codecs.make(spec).wire_bytes(0) == 0


def test_codec_kernels_knob_reaches_the_select():
    codec = codecs.make("topk:0.5", kernels="on")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        codec.roundtrip({"a": torch.ones(4)}, torch.Generator())
    sent, _ = codecs.make("topk:0.5", kernels="off").roundtrip(
        {"a": torch.tensor([1.0, -4.0, 2.0, 0.5])}, torch.Generator())
    assert torch.equal(sent["a"], torch.tensor([0.0, -4.0, 2.0, 0.0]))
