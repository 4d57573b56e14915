"""The port's dense transformer against the JAX package's, on the CPU.

Module by module on seeded inputs (norms, RoPE full and half, M-RoPE, the
gated MLPs, the flash core, decode attention), at rtol 1e-4 / atol 1e-5.
Then the whole model for the four dense archs at their reduced configs,
with the reference's ``init_params(PRNGKey(0))`` carried across by
``convert.lm_params_from_numpy``: train-mode hidden states, prefill logits
and cache, and 4 decode steps from one padded cache built on both sides.

Whole-model tensors are held at rtol 1e-4 and an atol of 1e-4 of the
tensor's largest magnitude (:func:`assert_close_scaled`).  The elementwise
atol of 1e-5 sits below the reference's own float32 noise on these models:
its queries and keys reach |15| at head_dim 16, so the softmax is nearly
one-hot and a one-ulp difference in a norm moves a score by ~10⁻⁵; the
reference run under ``jax.jit`` differs from its own eager run by more
than rtol 1e-4 / atol 1e-5 (:func:`test_reference_fp32_noise_exceeds_elementwise_atol`).

Then the families that wait for A9.3 raise, and ``init_params`` is
deterministic and draws each leaf as its spec says.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import model_api as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import model_api as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
DENSE = ("chatglm3-6b", "deepseek-coder-33b", "gemma3-1b", "llama3-405b")
LATER = {"moe": "mixtral-8x7b", "rwkv": "rwkv6-3b", "hybrid": "zamba2-7b",
         "encdec": "whisper-small", "vlm": "qwen2-vl-2b"}
B, S, STEPS = 2, 24, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test, as the port's other long CPU files pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def assert_close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def assert_close_scaled(got, want, what=""):
    """rtol 1e-4; atol 1e-4 of the reference tensor's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=what)


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(reference cfg, reference params, port cfg, port module) of a reduced
    dense arch, the port's weights carried across from the reference's."""
    cfg = ref_get_config(arch, reduced=True)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = get_config(arch, reduced=True)
    model = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, model


def tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)


# --- module by module ---------------------------------------------------------


def test_norms_match_reference(rng):
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3
    w, b = (rng.normal(size=(64,)).astype(np.float32) * 0.1 for _ in range(2))
    for eps in (1e-5, 1e-6):
        assert_close(tc.rms_norm(t(x), t(w), eps), jc.rms_norm(x, w, eps))
        assert_close(tc.layer_norm(t(x), t(w), t(b), eps), jc.layer_norm(x, w, b, eps))
    # 1 + w in float32, the result in x's dtype
    xb = torch.tensor(x, dtype=torch.bfloat16)
    assert tc.rms_norm(xb, t(w)).dtype == torch.bfloat16
    assert_close(tc.rms_norm(xb, t(w)).float(),
                 np.asarray(jc.rms_norm(jnp.asarray(x, jnp.bfloat16), w), np.float32))
    assert_close(tc.softcap(t(x), 30.0), jc.softcap(x, 30.0))
    assert tc.softcap(t(x), 0.0).equal(t(x))


@pytest.mark.parametrize("pct", (1.0, 0.5), ids=("full", "half"))
@pytest.mark.parametrize("theta", (10_000.0, 1_000_000.0))
def test_rope_matches_reference(pct, theta, rng):
    hd = 16
    rd = int(hd * pct)
    pos = np.stack([np.arange(40), rng.integers(0, 2000, 40)]).astype(np.int32)
    x = rng.normal(size=(2, 40, 4, hd)).astype(np.float32)
    cj, sj = jc.rope_cos_sin(jnp.asarray(pos), rd, theta)
    ct, st = tc.rope_cos_sin(t(pos), rd, theta)
    assert_close(tc.rope_freqs(rd, theta), jc.rope_freqs(rd, theta))
    assert_close(ct, cj)
    assert_close(st, sj)
    assert_close(tc.apply_rope(t(x), ct, st, rd), jc.apply_rope(x, cj, sj, rd))
    # a partial rotary part leaves the rest untouched, in its dtype
    xb = torch.tensor(x, dtype=torch.bfloat16)
    out = tc.apply_rope(xb, ct, st, rd)
    assert out.dtype == torch.bfloat16 and out[..., rd:].equal(xb[..., rd:])


def test_mrope_matches_reference(rng):
    pos = rng.integers(0, 500, (3, 2, 12)).astype(np.int32)
    for rd, sections in ((32, (4, 6, 6)), (128, (16, 24, 24))):
        cj, sj = jc.mrope_cos_sin(jnp.asarray(pos), rd, 1_000_000.0, sections)
        ct, st = tc.mrope_cos_sin(t(pos), rd, 1_000_000.0, sections)
        assert_close(ct, cj)
        assert_close(st, sj)
    with pytest.raises(ValueError, match="sections"):
        tc.mrope_cos_sin(t(pos), 32, 1e6, (4, 6, 5))


@pytest.mark.parametrize("act", ("silu", "gelu", "gelu_nogate", "relu"))
def test_mlp_matches_reference(act, rng):
    specs = jc.mlp_specs(64, 160, act)
    assert tc.mlp_specs(64, 160, act) == {k: tc.ParamSpec(*dataclass_values(v))
                                          for k, v in specs.items()}
    w = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in specs.items()}
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    assert_close(tc.mlp_apply({k: t(v) for k, v in w.items()}, t(x), act),
                 jc.mlp_apply(w, x, act))


def test_gelu_is_the_tanh_approximation(rng):
    x = rng.normal(size=1000).astype(np.float32) * 4
    got = tc.ACTIVATIONS["gelu"](t(x))
    assert_close(got, jax.nn.gelu(x, approximate=True))
    exact = torch.nn.functional.gelu(t(x))
    assert (got - exact).abs().max() > 1e-4   # torch's default is another function


def dataclass_values(spec):
    return spec.shape, spec.axes, spec.init, spec.scale, spec.dtype


def attention_inputs(rng, b, s, n, g, d, sk=None):
    sk = sk or s
    q = rng.normal(size=(b, s, n, g, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, n, d)).astype(np.float32)
    return q, k, v


FLASH_CASES = {
    "causal": dict(s=40, window=None, softcap=0.0),
    "window": dict(s=40, window=8, softcap=0.0),
    "global layer (window 0)": dict(s=40, window=0, softcap=0.0),
    "softcap": dict(s=40, window=None, softcap=30.0),
    "3 q-blocks x 3 kv-blocks": dict(s=1536, window=512, softcap=0.0),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_core_matches_reference(case, rng):
    c = FLASH_CASES[case]
    s = c["s"]
    b, n, g, d = (1, 1, 2, 16) if s > 100 else (2, 2, 2, 16)
    q, k, v = attention_inputs(rng, b, s, n, g, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[-1, :3] = -1                       # unwritten slots are masked out
    kw = dict(causal=True, window=c["window"], softcap=c["softcap"], scale=0.25)
    want = ja._flash_core(q, k, v, pos, pos, **kw)
    got = ta._flash_core(t(q), t(k), t(v), t(pos), t(pos), **kw)
    assert_close(got, want)
    # whole heads through the public entry point (GQA grouping, the dtype back)
    qh = q.reshape(b, s, n * g, d)
    want = ja.multihead_attention(qh, k, v, pos, pos, window=c["window"], softcap=c["softcap"])
    got = ta.multihead_attention(t(qh), t(k), t(v), t(pos), t(pos), window=c["window"],
                                 softcap=c["softcap"])
    assert_close(got, want)


def test_mask_matches_reference():
    qp = np.array([0, 5, 9, 20], np.int32)
    kp = np.array([-1, 0, 3, 5, 9, 12, 19, 20], np.int32)
    for causal in (True, False):
        for window in (None, 0, -1, 4, 16):
            want = ja._mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal, window=window)
            got = ta._mask(t(qp), t(kp), causal=causal, window=window)
            assert np.array_equal(got.numpy(), np.asarray(want)), (causal, window)
    assert ta.NEG_INF == ja.NEG_INF


@pytest.mark.parametrize("self_kv", (True, False), ids=("self_kv", "cache only"))
@pytest.mark.parametrize("window", (None, 6))
def test_decode_attention_matches_reference(self_kv, window, rng):
    b, n, g, d, S = 2, 2, 2, 16, 20
    q = rng.normal(size=(b, 1, n * g, d)).astype(np.float32)
    kc = rng.normal(size=(b, S, n, d)).astype(np.float32)
    vc = rng.normal(size=(b, S, n, d)).astype(np.float32)
    kv_pos = np.where(np.arange(S) < 14, np.arange(S), -1).astype(np.int32)
    kv_pos = np.stack([kv_pos, np.roll(kv_pos, 3)])       # a ring that wrapped
    q_pos = np.full((b, 1), 14, np.int32)
    kn, vn = (rng.normal(size=(b, 1, n, d)).astype(np.float32) for _ in range(2))
    want = ja.decode_attention(q, kc, vc, q_pos, kv_pos, window=window, softcap=0.0,
                               self_kv=(kn, vn) if self_kv else None)
    got = ta.decode_attention(t(q), t(kc), t(vc), t(q_pos), t(kv_pos), window=window,
                              softcap=0.0, self_kv=(t(kn), t(vn)) if self_kv else None)
    assert_close(got, want)


# --- the whole model --------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_specs_and_layer_meta_match_reference(arch):
    cfg, params, tcfg, model = models(arch)
    ref = jax.tree.leaves(jm.param_specs(cfg), is_leaf=jc.is_spec)
    got = [s for _, s in tc.spec_leaves(tm.param_specs(tcfg))]
    assert [dataclass_values(s) for s in got] == [dataclass_values(s) for s in ref]
    ref_cache = jm.cache_specs(cfg, 3, 17)
    got_cache = tm.cache_specs(tcfg, 3, 17)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_cache.items()} == \
        {k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in got_cache.items()}
    theta, window = tt.layer_meta(tcfg, tcfg.n_layers)
    rtheta, rwindow = jt.layer_meta(cfg, cfg.n_layers)
    assert np.array_equal(theta, np.asarray(rtheta)) and np.array_equal(window, np.asarray(rwindow))
    # the module holds the reference's tree, one block a layer
    assert len(model.blocks) == cfg.n_layers
    assert model.blocks[0].wq.shape == params["layers"]["wq"].shape[1:]
    assert model.blocks[-1].mlp["w_up"].equal(t(params["layers"]["mlp"]["w_up"][-1]))


@pytest.mark.parametrize("arch", DENSE)
def test_train_hidden_matches_reference(arch):
    cfg, params, tcfg, model = models(arch)
    toks = tokens(cfg)
    want = jm.apply(cfg, params, {"tokens": toks}, "train")
    got = tm.apply(tcfg, model, {"tokens": t(toks)}, "train")
    assert got.shape == (B, S + STEPS, cfg.d_model) and got.dtype == torch.float32
    assert_close_scaled(got, want)
    assert model({"tokens": t(toks)}, "train").equal(got)      # the module's forward


def padded(cache, steps):
    """A prefill cache of s slots widened by ``steps`` unwritten ones."""
    pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
    return {"k": np.pad(np.asarray(cache["k"]), pad), "v": np.pad(np.asarray(cache["v"]), pad),
            "kv_pos": np.pad(np.asarray(cache["kv_pos"]), [(0, 0), (0, steps)],
                             constant_values=-1),
            "cur": np.asarray(cache["cur"])}


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    cfg, params, tcfg, model = models(arch)
    toks = tokens(cfg, seed=1)
    want_logits, want_cache = jm.apply(cfg, params, {"tokens": toks[:, :S]}, "prefill")
    got_logits, got_cache = tm.apply(tcfg, model, {"tokens": t(toks[:, :S])}, "prefill")
    assert got_logits.shape == (B, cfg.vocab_padded) and got_logits.dtype == torch.float32
    assert_close_scaled(got_logits, want_logits, "prefill logits")
    for key in ("k", "v"):
        assert_close_scaled(got_cache[key], want_cache[key], f"prefill cache {key}")
    assert np.array_equal(got_cache["kv_pos"].numpy(), np.asarray(want_cache["kv_pos"]))
    assert int(got_cache["cur"]) == int(want_cache["cur"]) == S

    # 4 decode steps from one padded cache, built on both sides
    ref_cache = jax.tree.map(jnp.asarray, padded(want_cache, STEPS))
    port_cache = convert.lm_cache_from_numpy(tcfg, padded(want_cache, STEPS), "cpu")
    for step in range(STEPS):
        tok = toks[:, S + step:S + step + 1]
        want, ref_cache = jm.apply(cfg, params, {"tokens": tok}, "decode", ref_cache)
        got, port_cache = tm.apply(tcfg, model, {"tokens": t(tok)}, "decode", port_cache)
        assert_close_scaled(got, want, f"decode step {step}")
    for key in ("k", "v"):
        assert_close_scaled(port_cache[key], ref_cache[key], f"decode cache {key}")
    assert np.array_equal(port_cache["kv_pos"].numpy(), np.asarray(ref_cache["kv_pos"]))
    assert int(port_cache["cur"]) == int(ref_cache["cur"]) == S + STEPS


def test_reference_fp32_noise_exceeds_elementwise_atol():
    """Why whole-model tensors take a scaled atol: the reference's jitted
    train forward of reduced deepseek-coder-33b differs from its own eager
    one by more than rtol 1e-4 / atol 1e-5, and within the scaled check."""
    cfg, params, _, _ = models("deepseek-coder-33b")
    toks = tokens(cfg)
    eager = np.asarray(jm.apply(cfg, params, {"tokens": toks}, "train"))
    jitted = np.asarray(jax.jit(lambda p, x: jm.apply(cfg, p, {"tokens": x}, "train"))(params, toks))
    with pytest.raises(AssertionError):
        assert_close(jitted, eager)
    assert_close_scaled(jitted, eager)


def test_decode_takes_one_token():
    cfg, params, tcfg, model = models("gemma3-1b")
    cache = tm.init_cache(tcfg, B, 8, "cpu")
    with pytest.raises(ValueError, match="one token"):
        tm.apply(tcfg, model, {"tokens": torch.zeros((B, 2), dtype=torch.int64)}, "decode", cache)


def test_init_cache_matches_reference():
    cfg, _, tcfg, _ = models("chatglm3-6b")
    want = jm.init_cache(cfg, 3, 10)
    got = tm.init_cache(tcfg, 3, 10, "cpu")
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
        assert str(got[key].dtype).removeprefix("torch.") == str(want[key].dtype), key


def test_init_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_cache(get_config("gemma3-1b", reduced=True), 1, 4)


# --- families, init -----------------------------------------------------------------


@pytest.mark.parametrize("family", LATER)
def test_later_families_raise(family):
    cfg = get_config(LATER[family], reduced=True)
    assert cfg.family == family
    calls = (lambda: tm.param_specs(cfg), lambda: tm.cache_specs(cfg, 1, 4),
             lambda: tm.init_params(cfg, torch.Generator().manual_seed(0)),
             lambda: tm.apply(cfg, None, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                              "train"))
    for call in calls:
        with pytest.raises(NotImplementedError, match="A9.3"):
            call()
    with pytest.raises(NotImplementedError, match="A9.3"):
        tt.dense_apply(cfg, None, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, "train")


def leaves(model):
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def module_leaf(model, path):
    """The leaf of the reference's tree at ``path`` in the port's module,
    a ``("layers", ...)`` leaf stacked over the blocks."""
    if path[0] != "layers":
        return getattr(model, path[0])
    return torch.stack([block.mlp[path[2]] if path[1] == "mlp" else getattr(block, path[1])
                        for block in model.blocks])


def test_init_params_deterministic():
    cfg = get_config("gemma3-1b", reduced=True)
    a = leaves(tm.init_params(cfg, torch.Generator().manual_seed(7)))
    b = leaves(tm.init_params(cfg, torch.Generator().manual_seed(7)))
    c = leaves(tm.init_params(cfg, torch.Generator().manual_seed(8)))
    assert a.keys() == b.keys() == c.keys()
    assert all(a[k].equal(b[k]) for k in a)
    assert not a["embedding"].equal(c["embedding"])
    # each leaf of the spec tree is init_leaf's stream for its index, one block a layer
    gen = torch.Generator().manual_seed(7)
    dt = getattr(torch, cfg.param_dtype)
    index = {path: (i, spec) for i, (path, spec) in enumerate(tc.spec_leaves(tm.param_specs(cfg)))}
    i, spec = index[("embedding",)]
    assert a["embedding"].equal(tc.init_leaf(spec, gen, i, dt))
    i, spec = index[("layers", "mlp", "w_gate")]
    assert a["blocks.3.mlp.w_gate"].equal(tc.init_leaf(spec, gen, i, dt)[3])
    # leaf streams are independent: the same shape in two leaves differs
    assert not a["blocks.3.mlp.w_up"].equal(a["blocks.3.mlp.w_gate"])


@pytest.mark.parametrize("arch", ("gemma3-1b", "chatglm3-6b"))
def test_init_params_follow_the_specs(arch):
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    specs = tm.param_specs(cfg)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    for path, spec in tc.spec_leaves(specs):
        leaf = module_leaf(model, path)
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == torch.float32, path
        if spec.init == "zeros":
            assert not leaf.any(), path
        elif spec.init == "ones":
            assert (leaf == 1).all(), path
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[0]
            std = (spec.scale or 1.0) / np.sqrt(fan_in) if spec.init == "scaled" else 0.02
            n = leaf.numel()
            assert abs(float(leaf.std()) / std - 1) < 6 / np.sqrt(2 * n), path
            assert abs(float(leaf.mean())) < 6 * std / np.sqrt(n), path
    # a bf16 model draws in float32 and casts
    bf = tm.init_params(cfg.replace(param_dtype="bfloat16"), torch.Generator().manual_seed(0))
    assert bf.embedding.dtype == torch.bfloat16
    assert bf.embedding.equal(model.embedding.to(torch.bfloat16))