"""The bf16 flash kernel under autograd on the card: the forward's saved
f32 output and log-sum-exp, the hand-written backward against autograd
through the plain chunked path it replaces and against an f64 reference,
its determinism, and a bf16 train step at granite-8b's head shape whose
attention runs the kernel.  Marked ``cuda``: on a host without a CUDA
device every test skips with the reason.  Imports neither JAX nor the
reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_backward.py

Tolerances.  Kernel and plain path compute dq, dk and dv from the same
bf16 inputs with f32 scores, probabilities and products, and round each
once to bf16; they differ by f32 rounding before that (sums in other
orders, P and dS as bf16 hi + lo, ~2^-16 relative), so an element moves
by at most one bf16 ulp where the two f32 values straddle a rounding
boundary: |got - want| <= 2^-7 |want| plus, for elements near zero after
cancellation (the rows of dS sum to zero), 2^-10 of the tensor's largest
magnitude; and the whole tensor within 2^-8 of its norm.  Against the f64
reference the kernel's norm-relative error is at most 1.15x the plain
path's: both are set by the final bf16 rounding when P and dS enter the
products as bf16 hi + lo pairs (the CPU emulation of the kernel's tiles
reads 1.000x), while a kernel that rounded them to a single bf16 reads
~1.4x.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

pytestmark = pytest.mark.cuda

ULP, NEAR_ZERO, NORM = 2.0 ** -7, 2.0 ** -10, 2.0 ** -8

# B, H, KV, S, hd, causal, window: G = 1 and 4, S a multiple of 64 and
# ragged, causal, non-causal and windowed, each head dim the backward takes
BWD_CASES = [(1, 4, 4, 256, 128, True, 0), (1, 16, 4, 512, 128, True, 0),
             (1, 8, 2, 333, 128, True, 0), (1, 8, 8, 200, 128, False, 0),
             (2, 8, 2, 384, 128, False, 0), (1, 8, 2, 1000, 128, True, 96),
             (1, 4, 1, 300, 64, False, 64), (1, 4, 4, 257, 80, False, 0),
             (1, 2, 1, 37, 32, True, 5), (1, 4, 2, 129, 64, True, 0),
             (1, 8, 2, 640, 80, True, 200), (1, 4, 1, 64, 128, False, 0)]
GRANITE = (1, 32, 8, 4096, 128, True, 0)   # granite-8b's train step, one sequence


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _inputs(dev, B, H, KV, S, hd, seed, layout="bhsd"):
    """bf16 q, k, v and an output gradient; ``layout`` "bshd" hands them
    over as the model does, (B, S, heads, hd) tensors transposed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))
    if layout == "bshd":
        return [torch.randn((s[0], s[2], s[1], s[3]), generator=gen,
                            device=dev).bfloat16().transpose(1, 2)
                for s in shapes]
    return [torch.randn(s, generator=gen, device=dev).bfloat16() for s in shapes]


def _cfg(H, KV, hd, window):
    from repro_torch.configs import granite_8b
    return granite_8b.CONFIG.replace(
        num_heads=H, num_kv_heads=KV, head_dim=hd,
        attn_variant="sliding_window" if window else "full",
        window=window or 4096)


def _plain(q, k, v, dout, causal, window):
    """out, dq, dk, dv by autograd through the chunked plain path on the
    same bf16 inputs."""
    ins = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    S = q.shape[2]
    out = attention._chunked_attention(
        *ins, _cfg(q.shape[1], k.shape[1], q.shape[3], window),
        torch.arange(S, device=q.device), causal)
    grads = torch.autograd.grad(out, ins, dout.transpose(1, 2))
    return [out.detach().transpose(1, 2)] + [g.transpose(1, 2) for g in grads]


def _kernel(q, k, v, dout, causal, window):
    """out, dq, dk, dv through ops.flash_attention on the kernel route."""
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.BWD_CALLS
    out = ops.flash_attention(*ins, causal=causal, window=window, mode="on")
    grads = torch.autograd.grad(out, ins, dout)
    assert flash_attention.BWD_CALLS == before + 1
    return [out.detach()] + list(grads)


def _assert_close(got, want, name):
    g, w = got.float(), want.float()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
    assert bool(torch.isfinite(g).all()), name
    err = (g - w).abs()
    bound = ULP * w.abs() + NEAR_ZERO * float(w.abs().max())
    assert bool((err <= bound).all()), (name, float((err / bound).max()))
    assert float((g - w).norm()) <= NORM * float(w.norm()), (
        name, float((g - w).norm() / w.norm()))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", BWD_CASES + [GRANITE])
def test_backward_matches_autograd_through_the_plain_path(
        cuda, B, H, KV, S, hd, causal, window):
    q, k, v, dout = _inputs(cuda, B, H, KV, S, hd, S + H + hd, "bshd")
    got = _kernel(q, k, v, dout, causal, window)
    want = _plain(q, k, v, dout, causal, window)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_close(g, w, name)
    for g, t in zip(got[1:], (q, k, v)):
        assert g.stride() == t.stride()   # in the inputs' layouts


def test_backward_as_accurate_as_the_plain_path_against_f64(cuda):
    """At (1, 8, 2, 1,024, 128, causal) the kernel's dq, dk and dv are no
    further from the f64 gradients of the same bf16 inputs than 1.15x the
    plain path's."""
    B, H, KV, S, hd = 1, 8, 2, 1024, 128
    q, k, v, dout = _inputs(cuda, B, H, KV, S, hd, 11)
    got = _kernel(q, k, v, dout, True, 0)[1:]
    plain = _plain(q, k, v, dout, True, 0)[1:]
    ins = [t.detach().cpu().double().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_ref(*ins, causal=True)
    exact = torch.autograd.grad(out, ins, dout.cpu().double())
    for name, g, p, x in zip(("dq", "dk", "dv"), got, plain, exact):
        rel_g = float((g.cpu().double() - x).norm() / x.norm())
        rel_p = float((p.cpu().double() - x).norm() / x.norm())
        assert rel_g <= 1.15 * rel_p, (name, rel_g, rel_p)


def test_forward_saves_the_f32_output_and_log_sum_exp(cuda):
    """Under autograd the forward keeps the f32 output, whose bf16 rounding
    is the output bit for bit, and each row's log-sum-exp of the scaled
    scores (rows padded to ROW_PAD); the output equals the prefill
    kernel's bit for bit."""
    B, H, KV, S, hd = 1, 8, 2, 333, 128
    q, k, v, _ = _inputs(cuda, B, H, KV, S, hd, 3, "bshd")
    out, o32, lse = flash_attention._forward(q, k, v, True, 0, save=True)
    assert lse.shape == (B, H, 384) and o32.stride() == q.stride()
    assert torch.equal(o32.bfloat16(), out)
    with torch.no_grad():
        assert torch.equal(out, ops.flash_attention(q, k, v, mode="on"))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(H // KV, 1)) * hd ** -0.5
    i = torch.arange(S, device=cuda)
    s = torch.where(i[:, None] >= i[None, :], s, ref.NEG_INF)
    torch.testing.assert_close(lse[..., :S], torch.logsumexp(s, -1),
                               rtol=1e-5, atol=1e-5)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(o32, want, rtol=2e-5, atol=2e-5)
    assert bool(torch.isfinite(lse).all())


def test_double_backward_raises(cuda):
    """The backward launches through ctypes, so its results carry no graph
    of their own: a gradient of the gradient raises rather than treat dq,
    dk and dv as constants."""
    q, k, v, _ = _inputs(cuda, 1, 4, 2, 128, 64, 9)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*ins, mode="on")
    dq = torch.autograd.grad(out.float().square().sum(), ins[0],
                             create_graph=True)[0]
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dq.float().sum().backward()


def test_backward_twice_gives_the_same_bits(cuda):
    q, k, v, dout = _inputs(cuda, *GRANITE[:5], 5, "bshd")
    first = _kernel(q, k, v, dout, True, 0)
    second = _kernel(q, k, v, dout, True, 0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_train_step_runs_attention_through_the_kernel(cuda):
    """A bf16 step at granite-8b's head shape (32/8 heads of 128, 2 layers,
    remat) with kernels="auto" against "off" from the same init on the
    same batch: the backward runs once a layer and cohort (2 x 4 calls a
    step) and no attention under grad takes the plain path; "off" runs the
    plain path (2 x 4 x 2 calls with remat) and no kernel.  The losses
    agree within 2e-3 relative and each gradient leaf within 2e-2 of its
    norm: the two attentions differ only by their f32 roundings, but a bf16
    model carries an output that moved by one bf16 ulp through every later
    product in bf16."""
    from repro_torch.configs import granite_8b
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_leaves, tree_unflatten

    cfg = granite_8b.CONFIG.replace(num_layers=2, d_ff=1024, vocab_size=2048)
    ocfg = train.opt_config(cfg)
    toks = torch.from_numpy(zipf_tokens(4, 512, cfg.vocab_size, seed=7)).to(cuda)
    losses, grads = {}, {}
    for mode, bwd, plain in (("auto", 8, 0), ("off", 0, 16)):
        params, opt = train.init_train_state(
            cfg, ocfg, torch.Generator(device=cuda).manual_seed(0),
            device=cuda)
        step = train.make_train_step(cfg, ocfg, n_micro=4, kernels=mode)
        before = flash_attention.BWD_CALLS, attention.PLAIN_GRAD_CALLS
        _, _, stats = step(params, opt, {"tokens": toks})
        torch.cuda.synchronize()
        assert (flash_attention.BWD_CALLS - before[0],
                attention.PLAIN_GRAD_CALLS - before[1]) == (bwd, plain)
        losses[mode] = float(stats["loss"])
        params = model.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss, _ = model.loss_fn(tree_unflatten(params, leaves), cfg,
                                {"tokens": toks[:1]}, kernels=mode)
        grads[mode] = torch.autograd.grad(loss, leaves)
        del params, opt, step, leaves
    assert abs(losses["auto"] - losses["off"]) <= 2e-3 * abs(losses["off"])
    for a, o in zip(grads["auto"], grads["off"]):
        assert float((a.float() - o.float()).norm()) <= 2e-2 * float(
            o.float().norm())
