"""The port's serving path (``repro_torch.launch``) on the CPU.

``serve`` decodes each step within 2e-3 of the port's own full forward at
that position (the reference's decode tolerance,
``tests/test_models_smoke.py``), and its greedy tokens equal the JAX
package's greedy decode from the same weights and the same padded cache
(but after a step where the reference's top two logits lie within 1e-4,
which the test reports).  The prefill step pads its cache to ``seq_len``.
The reference's own prefill step does not, and its decode from a
prompt-length cache parts from the full forward by more than one logit
from the second new token on: that fault is pinned here.  The CLI and the
example exit 0 on the CPU.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import model_api as jm  # noqa: E402
from repro.models.embedding import logits_fn as ref_logits_fn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step, pad_cache  # noqa: E402
from repro_torch.models import embedding as emb  # noqa: E402
from repro_torch.models import model_api as tm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DENSE = ("chatglm3-6b", "deepseek-coder-33b", "gemma3-1b", "llama3-405b")
DECODE_TOL = 2e-3            # the reference's decode-vs-forward tolerance
TIE = 1e-4                   # top-two logit gap below which greedy tokens may part
PROMPT, NEW = 12, 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def prompts(cfg, requests, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (requests, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def carried(arch):
    """The reference's reduced weights (PRNGKey(0)) and the port's copy."""
    cfg = ref_get_config(arch, reduced=True)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = get_config(arch, reduced=True)
    return cfg, params, tcfg, convert.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu")


def full_forward_logits(cfg, model, prompt_tokens, generated):
    """The port's train-mode forward over the prompt and the generated
    tokens but the last: logits (R, NEW, V) at the positions each step
    decoded."""
    seq = np.concatenate([prompt_tokens, generated[:, :-1]], axis=1)
    hidden = tm.apply(cfg, model, {"tokens": torch.tensor(seq)}, "train")
    return emb.logits_fn(cfg, model.tree(), hidden[:, PROMPT - 1:])


@pytest.mark.parametrize("arch", DENSE)
def test_serve_matches_its_full_forward(arch):
    cfg = get_config(arch, reduced=True)
    model = tm.init_params(cfg, torch.Generator().manual_seed(3))
    p = prompts(cfg, 3)
    res = serve_mod.serve(cfg, model, p, batch=2, max_new=NEW, return_logits=True)
    assert res.tokens.shape == (3, NEW) and res.logits.shape == (3, NEW, cfg.vocab_padded)
    assert (res.batches, res.decode_steps) == (2, 2 * (NEW - 1))
    assert res.prefill_s > 0 and res.decode_s > 0
    # greedy: each token is its step's argmax
    assert np.array_equal(res.tokens, res.logits.argmax(-1).numpy())
    want = full_forward_logits(cfg, model, p, res.tokens)
    for step in range(NEW):
        np.testing.assert_allclose(res.logits[:, step].numpy(), want[:, step].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=f"step {step}")
    # a request's tokens do not depend on its batch or on the padding
    alone = serve_mod.serve(cfg, model, p[2:], batch=1, max_new=NEW)
    assert np.array_equal(alone.tokens, res.tokens[2:])


@pytest.mark.parametrize("arch", DENSE)
def test_float64_serve_equals_its_full_forward(arch):
    """A float64 model computes in float64 throughout, so its decode and
    its full forward agree to float64 rounding: what parts them in float32
    is rounding, not the decode's cache, mask or self-token fold-in."""
    cfg = get_config(arch, reduced=True).replace(param_dtype="float64",
                                                 compute_dtype="float64")
    model = tm.init_params(cfg, torch.Generator().manual_seed(3))
    p = prompts(cfg, 2)
    res = serve_mod.serve(cfg, model, p, batch=2, max_new=NEW, return_logits=True)
    assert res.logits.dtype == torch.float64
    want = full_forward_logits(cfg, model, p, res.tokens)
    assert want.dtype == torch.float64
    np.testing.assert_allclose(res.logits.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    # the same weights in float32: the float32 draws, cast
    model32 = tm.init_params(cfg.replace(param_dtype="float32"), torch.Generator().manual_seed(3))
    assert model32.embedding.double().equal(model.embedding)


def reference_greedy(cfg, params, p, steps, padded=True):
    """The JAX package's prefill, then greedy decode: from a cache padded to
    prompt + steps slots (the reference driver's stated intent) or from the
    prompt-length cache its prefill step returns.  Returns (tokens (R,
    steps), logits (R, steps, V))."""
    logits, cache = jm.apply(cfg, params, {"tokens": jnp.asarray(p)}, "prefill")
    if padded:
        pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
        cache = {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
                 "kv_pos": jnp.pad(cache["kv_pos"], [(0, 0), (0, steps)], constant_values=-1),
                 "cur": cache["cur"]}
    outs, seen = [jnp.argmax(logits, -1)], [logits]
    for _ in range(steps - 1):
        logits, cache = jm.apply(cfg, params, {"tokens": outs[-1][:, None]}, "decode", cache)
        outs.append(jnp.argmax(logits, -1))
        seen.append(logits)
    return np.stack([np.asarray(o) for o in outs], 1), np.stack([np.asarray(x) for x in seen], 1)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_tokens_equal_reference_greedy(arch):
    cfg, params, tcfg, model = carried(arch)
    p = prompts(cfg, 4, seed=1)
    got = serve_mod.serve(tcfg, model, p, batch=4, max_new=NEW).tokens
    want, ref_logits = reference_greedy(cfg, params, p, NEW)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < TIE
    compared = 0
    for r in range(len(p)):
        ties = np.flatnonzero(near_tie[r])
        upto = ties[0] if len(ties) else NEW      # the tokens may part from a near-tie on
        if len(ties):
            print(f"{arch} request {r}: near-tie at step {upto}; later steps not compared")
        assert np.array_equal(got[r, :upto], want[r, :upto]), (r, got[r], want[r])
        compared += upto
    assert compared >= len(p) * NEW // 2


def test_reference_prompt_length_cache_fault():
    """The reference's prefill cache has the prompt's length, and decode
    writes at ``cur % S``: from the second new token on it overwrites the
    prompt's first slot, and its logits leave the full forward by more than
    one (the case ROADMAP §C records: reduced chatglm3-6b, PRNGKey(0), two
    prompts of 8, then 4 tokens decoded; |dlogit| 5.1e-6, 2.22, 5.00,
    3.08).  The port's prefill step pads the cache to ``seq_len``: each
    step stays within the decode tolerance of the full forward."""
    cfg, params, tcfg, model = carried("chatglm3-6b")
    steps = 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8 + steps)).astype(np.int32)
    hidden = jm.apply(cfg, params, {"tokens": jnp.asarray(toks)}, "train")
    want = np.asarray(ref_logits_fn(cfg, params, hidden[:, 8:]))     # (2, steps, V)

    _, cache = jm.apply(cfg, params, {"tokens": jnp.asarray(toks[:, :8])}, "prefill")
    assert cache["k"].shape[2] == 8
    gaps = []
    for step in range(steps):
        logits, cache = jm.apply(cfg, params, {"tokens": toks[:, 8 + step:9 + step]}, "decode",
                                 cache)
        gaps.append(float(np.abs(np.asarray(logits) - want[:, step]).max()))
    print("reference decode from a prompt-length cache, |dlogit| a step:", gaps)
    assert gaps[0] < DECODE_TOL
    assert min(gaps[1:]) > 1.0

    # the port's steps on the same weights and tokens
    _, cache = make_prefill_step(tcfg, seq_len=8 + steps)(model, {"tokens": torch.tensor(toks[:, :8])})
    decode = make_decode_step(tcfg)
    for step in range(steps):
        logits, cache = decode(model, cache, {"tokens": torch.tensor(toks[:, 8 + step:9 + step])})
        np.testing.assert_allclose(logits.numpy(), want[:, step], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ("gemma3-1b", "chatglm3-6b"))
def test_prefill_step_pads_the_cache(arch):
    _, _, cfg, model = carried(arch)
    p = torch.tensor(prompts(cfg, 2))
    want_logits, want = tm.apply(cfg, model, {"tokens": p}, "prefill")
    logits, cache = make_prefill_step(cfg, seq_len=PROMPT + 5)(model, {"tokens": p})
    assert logits.equal(want_logits)
    assert cache["k"].shape[2] == cache["v"].shape[2] == cache["kv_pos"].shape[1] == PROMPT + 5
    for key in ("k", "v"):
        assert cache[key][:, :, :PROMPT].equal(want[key])
        assert not cache[key][:, :, PROMPT:].any()
    assert cache["kv_pos"][:, :PROMPT].equal(want["kv_pos"])
    assert (cache["kv_pos"][:, PROMPT:] == -1).all()
    assert int(cache["cur"]) == PROMPT
    # a decode step writes its slot and advances the position
    logits, cache = make_decode_step(cfg)(model, cache, {"tokens": logits.argmax(-1)[:, None]})
    assert int(cache["cur"]) == PROMPT + 1 and (cache["kv_pos"][:, PROMPT] == PROMPT).all()
    assert cache["k"][:, :, PROMPT].any() and not cache["k"][:, :, PROMPT + 1:].any()
    # a cache already as long is kept; one too short for the prompt is refused
    assert pad_cache(cfg, want, PROMPT) is want
    with pytest.raises(ValueError, match="seq_len"):
        pad_cache(cfg, want, PROMPT - 1)


def test_serve_refuses_empty_work():
    _, _, cfg, model = carried("gemma3-1b")
    with pytest.raises(ValueError, match=">= 1"):
        serve_mod.serve(cfg, model, prompts(cfg, 2), batch=2, max_new=0)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--arch", "gemma3-1b", "--reduced", "--requests", "1"])


ENTRY_POINTS = {
    "cli": ["-m", "repro_torch.launch.serve", "--arch", "chatglm3-6b", "--reduced",
            "--requests", "4", "--batch", "2", "--prompt-len", "8", "--max-new", "4",
            "--device", "cpu"],
    "example": ["examples/serve_lm_torch.py", "--device", "cpu"],
    "cli gemma3 --no-mesh": ["-m", "repro_torch.launch.serve", "--arch", "gemma3-1b",
                             "--reduced", "--requests", "3", "--batch", "2", "--prompt-len",
                             "16", "--max-new", "3", "--no-mesh", "--device", "cpu"],
}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_exits_0(entry):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, *ENTRY_POINTS[entry]], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] arch=") and "device=cpu" in lines[0]
    assert "requests" in lines[1] and "decode steps" in lines[1] and "tok/s" in lines[1]
    assert lines[2].startswith("[serve] sample output tokens:")
