"""The port's inference engine against the JAX package's on the CPU: a tiny
float32 Llama-3 whose weights and LoRA adapters are drawn by JAX and carried
across, driven through the scenarios of ``tests/test_engine.py`` (warm
prefix against full prefill, cold prefix, priority admission, LoRA pool
eviction) and the timing of ``apply_prewarm_plan``.  Both engines must give
the same output tokens, prefix-hit flags, completion order and LoRA hit,
miss and merge counts.

Greedy tokens can only agree if no argmax is a near-tie: every scenario
asserts that the JAX engine's smallest top-2 logit margin exceeds ten times
the float32 logits tolerance of ``tests/test_torch_model.py`` (1e-4), so a
flipped token can only be a defect.

The same scenarios run on a tiny float32 Qwen1.5-MoE.  Also: ``serve.main``
on the CPU serves as many LLM requests as the JAX package's, and the tiny
MoE model serves every request of the ten-app trace."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.prewarm import PrewarmPlan as JaxPrewarmPlan
from repro.launch import serve as jax_serve
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.lora import LoraAdapter as JaxLoraAdapter
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.core.prewarm import PrewarmPlan
from repro_torch.launch import serve
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.lora import lora_from_jax
from repro_torch.testing import tiny_config

LOGITS_TOL = 1e-4
PREFIXES = {"p1": list(range(10, 30)), "p2": list(range(40, 70))}


def _models(arch):
    kw = dict(num_layers=2, dtype="float32")
    jm = jax_build_model(jax_tiny_config(arch, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(tiny_config(arch, **kw), device="cpu")
    pm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    adapters = [_adapter(jp, i) for i in range(3)]
    return jm, jp, pm, adapters


@pytest.fixture(scope="module")
def models():
    return _models("llama3-8b")


@pytest.fixture(scope="module")
def moe_models():
    return _models("qwen2-moe-a2.7b")


def _adapter(params, i, rank=8):
    """A JAX-side adapter on every attention wq/wv, drawn from a numpy
    seed (the JAX package's ``make_random_adapter`` seeds from Python's
    per-process salted ``hash``, so its adapters differ between runs).
    Seeds 200..202: the scenarios' margin assertion holds for them (seeds
    100..102 put one LoRA token's top-2 logits 8.6e-5 apart)."""
    rng = np.random.default_rng(200 + i)
    deltas = {}
    for leaf in ("wq", "wv"):
        n, din, dout = params["layers"]["sub0"]["attn"][leaf].shape
        a = rng.normal(size=(n, din, rank)).astype(np.float32) * 0.02
        b = rng.normal(size=(n, rank, dout)).astype(np.float32) * 0.02
        deltas[f"layers/sub0/attn/{leaf}"] = (jnp.asarray(a), jnp.asarray(b))
    return JaxLoraAdapter(f"l{i}", rank, deltas, 0.5)


class _Side:
    """One engine, its Request class and (JAX side) the top-2 margin of
    every logits row it computed."""

    def __init__(self, engine, request_cls, margins=None):
        self.eng, self.Request, self.margins = engine, request_cls, margins


def _engines(models, **kw):
    jm, jp, pm, adapters = models
    base = dict(max_slots=2, max_seq=96, prefix_prompts=PREFIXES)
    base.update(kw)
    jeng = JaxEngine(jm, jp, **base)
    peng = InferenceEngine(pm, **base)
    for a in adapters:
        jeng.lora.register(a)
        peng.lora.register(lora_from_jax(a))
    margins = []
    computing_prefix = []

    def record(fn):
        def wrapped(*args):
            out = fn(*args)
            if not computing_prefix:       # a prefix's logits go unused
                top = np.sort(np.asarray(out[1][0, -1], np.float64))[-2:]
                margins.append(top[1] - top[0])
            return out
        return wrapped

    def prefix(fn):
        def wrapped(prefix_id):
            computing_prefix.append(prefix_id)
            try:
                return fn(prefix_id)
            finally:
                computing_prefix.pop()
        return wrapped

    jeng._prefill = record(jeng._prefill)
    jeng._decode = record(jeng._decode)
    jeng.prefix.compute_fn = prefix(jeng.prefix.compute_fn)
    return _Side(jeng, JaxRequest, margins), _Side(peng, Request)


def _warm_vs_full(side):
    eng, R = side.eng, side.Request
    eng.prewarm_prefix("p1")
    warm = R("w", prompt=[1, 2, 3], max_new_tokens=6, prefix_id="p1")
    eng.submit(warm)
    eng.run()
    full = R("f", prompt=PREFIXES["p1"] + [1, 2, 3], max_new_tokens=6)
    eng.submit(full)
    eng.run()
    assert warm.prefix_hit is True and warm.output == full.output


def _cold_prefix(side):
    """The first request computes the prefix (a miss); the second, admitted
    in the same step, hits it, and both decode side by side from it."""
    eng, R = side.eng, side.Request
    r = R("c", prompt=[5, 6], max_new_tokens=4, prefix_id="p2")
    s = R("d", prompt=[9], max_new_tokens=5, prefix_id="p2")
    eng.submit(r)
    eng.submit(s)
    eng.run()
    assert r.prefix_hit is False and len(r.output) == 4
    assert s.prefix_hit is True and len(s.output) == 5


def _priority(side):
    eng, R = side.eng, side.Request
    ranks = {"hi": 0.0, "lo": 1.0, "mid": 0.5}
    eng.submit(R("a", prompt=[1], max_new_tokens=2, app_id="lo"))
    eng.submit(R("b", prompt=[2], max_new_tokens=3, app_id="hi"))
    eng.submit(R("c", prompt=[3, 4], max_new_tokens=2, app_id="mid",
                 prefix_id="p1"))
    eng.run(rank_fn=lambda r: ranks[r.app_id])
    assert [r.app_id for r in eng.done] == ["hi", "mid", "lo"]


def _lora_eviction(side):
    eng, R = side.eng, side.Request
    for i, lid in enumerate(["l0", "l1", "l2", "l0", "", "l2"]):
        eng.submit(R(f"r{i}", prompt=[7, i + 1], max_new_tokens=3,
                     lora_id=lid, prefix_id="p2" if i % 2 else ""))
        eng.run()
    assert not eng.lora.is_warm("l1") and eng.lora.is_warm("l2")


def _prewarm_plan_timing(side, plan_cls):
    eng, R = side.eng, side.Request
    plan = plan_cls(app_ids=["a"] * 4,
                    resource_keys=["kv:p1", "kv:p9", "lora:l1", "docker:img"],
                    kinds=["llm", "llm", "llm", "docker"],
                    fire_at=np.asarray([0.0, 0.0, 50.0, 0.0]),
                    p_reach=np.ones(4, np.float32))
    acted = [eng.apply_prewarm_plan(plan, now=10.0)]
    warm = ("p1" in eng.prefix.entries, eng.lora.is_warm("l1"))
    acted.append(eng.apply_prewarm_plan(plan, now=60.0))
    assert acted == [1, 2] and warm == (True, False)
    r = R("x", prompt=[9, 8], max_new_tokens=4, prefix_id="p1",
          lora_id="l1")
    eng.submit(r)
    eng.run()
    assert r.prefix_hit is True and eng.lora.misses == 0 < eng.lora.hits


SCENARIOS = {"warm_vs_full": (_warm_vs_full, {}),
             "cold_prefix": (_cold_prefix, {}),
             "priority": (_priority, dict(max_slots=1)),
             "lora_eviction": (_lora_eviction, dict(lora_capacity=2)),
             "prewarm_plan": (None, {})}


def _summary(eng):
    return ([(r.req_id, r.output, r.prefix_hit) for r in eng.done],
            (eng.lora.hits, eng.lora.misses, eng.lora.merges),
            (eng.prefix.hits, eng.prefix.misses))


def _same_engine_run(models, scenario):
    fn, kw = SCENARIOS[scenario]
    jside, pside = _engines(models, **kw)
    if fn is None:
        _prewarm_plan_timing(jside, JaxPrewarmPlan)
        _prewarm_plan_timing(pside, PrewarmPlan)
    else:
        fn(jside)
        fn(pside)
    assert jside.margins and min(jside.margins) > 10 * LOGITS_TOL
    assert _summary(pside.eng) == _summary(jside.eng)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_jax(models, scenario):
    _same_engine_run(models, scenario)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_moe_engine_matches_jax(moe_models, scenario):
    """The tiny float32 Qwen1.5-MoE: LoRA merges touch ``attn.wq``/``wv``
    as in the dense model; decode steps take the dense MoE dispatch and
    prefills the sort dispatch, on both sides."""
    _same_engine_run(moe_models, scenario)


def _served(text):
    return int(re.search(r"(\d+) llm requests served", text).group(1))


def test_serve_main_serves_the_moe_model(capsys):
    """``serve`` on the tiny MoE model serves the trace's 43 distinct LLM
    requests, as it does on the dense model."""
    cfg = tiny_config("qwen2-moe-a2.7b")
    assert serve.main(["--apps", "10"], cfg=cfg, device="cpu") == 0
    assert _served(capsys.readouterr().out) == 43


def test_serve_main_serves_as_many_requests_as_jax(capsys):
    assert serve.main(["--apps", "4"], device="cpu") == 0
    port = _served(capsys.readouterr().out)
    assert jax_serve.main(["--apps", "4"]) == 0
    assert port == _served(capsys.readouterr().out) > 0
