"""The ten representative LLM applications (Fig. 1) as AppSpecs.

Sizes follow §5.1: small (EV, FEV, CC, ALFWI, KBQAV — under a minute of
demand), medium (CG, PE — plus LLMR, which Fig. 1 includes but the arrival mix
omits), large (DM, MRS — ten-plus minutes).  Latent-z scaling and
prev-observation coupling reproduce the correlation structure of Fig. 6;
loops/branches give the probabilistic next-unit structure.

Token-time constants are calibrated against an A100-class engine
(t_in = 0.25 ms/input token, t_out = 30 ms/output token) — the simulator can
override these with roofline-derived TPU numbers.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.apps.spec import (AppSpec, UnitSpec, branch, lognorm, loop, then,
                             track, uniform, profile_app)
from repro_torch.core.pdgraph import BackendSpec, PDGraph

T_IN = 0.25e-3
T_OUT = 30e-3

_L = lambda unit, app, lora="": BackendSpec("llm", model="llama3-8b",
                                            lora=lora, prefix=f"{app}.{unit}")
_DOCKER = BackendSpec("docker", model="python:3.10-slim")
_ALF = BackendSpec("docker", model="alfworld-env")
_VIT = BackendSpec("dnn", model="vit-large")
_DIFF = BackendSpec("dnn", model="stable-diffusion")
_SEARCH = BackendSpec("dnn", model="search-index")


def _dm() -> AppSpec:  # Document Merging (Graph-of-Thoughts) — large
    a = "DM"
    units = {
        "split": UnitSpec("split", _L("split", a), in_len=lognorm(8000, 0.3, z_weight=0.5),
                          out_len=lognorm(400, 0.3), par=lambda r, c: 1,
                          next=then("score")),
        "score": UnitSpec("score", _L("score", a),
                          in_len=lognorm(1200, 0.12, prev_key="out", prev_weight=0.7),
                          out_len=lognorm(50, 0.3), par=uniform(8, 12, z_weight=0.4),
                          next=then("aggregate")),
        "aggregate": UnitSpec("aggregate", _L("aggregate", a),
                              in_len=lognorm(3000, 0.3, z_weight=0.4),
                              out_len=lognorm(400, 0.3), par=uniform(4, 6),
                              next=then("merge")),
        "merge": UnitSpec("merge", _L("merge", a),
                          in_len=lognorm(6000, 0.12, z_weight=0.4, prev_key="out",
                                         prev_weight=0.7),
                          out_len=lognorm(1000, 0.25, z_weight=0.3),
                          par=lambda r, c: 1,
                          next=loop("score", 0.85, None, max_visits=9,
                                    z_weight=0.25, loop_from="score")),
    }
    return AppSpec(a, "split", units, "large")


def _mrs() -> AppSpec:  # MapReduce Summarization — large
    a = "MRS"
    units = {
        "map": UnitSpec("map", _L("map", a), in_len=lognorm(3000, 0.25),
                        out_len=lognorm(300, 0.3, z_weight=0.3),
                        par=uniform(14, 30, z_weight=0.6), next=then("reduce")),
        "reduce": UnitSpec("reduce", _L("reduce", a),
                           in_len=lognorm(2500, 0.3, prev_key="out", prev_weight=0.5),
                           out_len=lognorm(400, 0.3),
                           par=uniform(4, 8, z_weight=0.5),
                           next=loop("reduce", 0.62, "final", max_visits=5,
                                     z_weight=0.3)),
        "final": UnitSpec("final", _L("final", a), in_len=lognorm(2000, 0.3),
                          out_len=lognorm(500, 0.3), par=lambda r, c: 1,
                          next=then(None)),
    }
    return AppSpec(a, "map", units, "large")


def _llmr() -> AppSpec:  # LLM Reasoning (certaindex-style) — medium (not in mix)
    a = "LLMR"
    units = {
        "expand": UnitSpec("expand", _L("expand", a),
                           in_len=lognorm(800, 0.3, z_weight=0.4),
                           out_len=lognorm(300, 0.4, z_weight=0.4),
                           par=uniform(3, 5),
                           next=loop("expand", 0.72, "answer", max_visits=6,
                                     z_weight=0.4)),
        "answer": UnitSpec("answer", _L("answer", a), in_len=lognorm(1500, 0.3),
                           out_len=lognorm(250, 0.3), par=lambda r, c: 1,
                           next=then(None)),
    }
    return AppSpec(a, "expand", units, "medium")


def _ev() -> AppSpec:  # Equation Verification (FacTool math) — small
    a = "EV"
    units = {
        "extract": UnitSpec("extract", _L("extract", a), in_len=lognorm(600, 0.3),
                            out_len=lognorm(150, 0.4, z_weight=0.4),
                            par=lambda r, c: 1, next=then("calc")),
        "calc": UnitSpec("calc", _DOCKER, dur=uniform(2, 8, z_weight=0.4),
                         next=then("summ")),
        "summ": UnitSpec("summ", _L("summ", a), in_len=lognorm(400, 0.3),
                         out_len=lognorm(80, 0.3), par=lambda r, c: 1,
                         next=then(None)),
    }
    return AppSpec(a, "extract", units, "small")


def _fev() -> AppSpec:  # Fact Extraction & Verification (ReAct FEVER) — small
    a = "FEV"
    units = {
        "extract": UnitSpec("extract", _L("extract", a, lora="fever-extractor"),
                            in_len=lognorm(900, 0.3, z_weight=0.4),
                            out_len=lognorm(120, 0.35, z_weight=0.5),
                            par=lambda r, c: 1, next=then("verify")),
        "verify": UnitSpec("verify", _L("verify", a, lora="fever-verifier"),
                           in_len=lognorm(700, 0.3),
                           out_len=lognorm(60, 0.3),
                           par=track("extract", "out", scale=0.05,
                                     jitter=0.1, fallback=4),
                           next=then(None)),
    }
    return AppSpec(a, "extract", units, "small")


def _cc() -> AppSpec:  # Code Checking (FacTool code) — small
    a = "CC"
    units = {
        "snippets": UnitSpec("snippets", _L("snippets", a),
                             in_len=lognorm(800, 0.3), out_len=lognorm(200, 0.4),
                             par=lambda r, c: 1, next=then("exec")),
        "exec": UnitSpec("exec", _DOCKER, dur=uniform(4, 11, z_weight=0.3),
                         next=then("review")),
        "review": UnitSpec("review", _L("review", a), in_len=lognorm(900, 0.3),
                           out_len=lognorm(100, 0.3), par=lambda r, c: 1,
                           next=loop("exec", 0.3, None, max_visits=3)),
    }
    return AppSpec(a, "snippets", units, "small")


def _alfwi() -> AppSpec:  # ALFWorld Interaction (ReAct) — small
    a = "ALFWI"
    units = {
        "think": UnitSpec("think", _L("think", a),
                          in_len=lognorm(1200, 0.25, prev_key="in", prev_weight=0.5),
                          out_len=lognorm(80, 0.3), par=lambda r, c: 1,
                          next=then("act")),
        "act": UnitSpec("act", _ALF, dur=uniform(0.2, 0.6),
                        next=loop("think", 0.85, None, max_visits=12,
                                  z_weight=0.3, loop_from="think")),
    }
    return AppSpec(a, "think", units, "small")


def _cg() -> AppSpec:  # Code Generation (AutoGen-style) — medium
    a = "CG"
    units = {
        "plan": UnitSpec("plan", _L("plan", a, lora="coder"),
                         in_len=lognorm(500, 0.3, z_weight=0.5),
                         out_len=lognorm(300, 0.18, z_weight=0.7),
                         par=lambda r, c: 1, next=then("generate")),
        "generate": UnitSpec("generate", _L("generate", a, lora="coder"),
                             in_len=lognorm(1500, 0.12, prev_key="out", prev_weight=0.75),
                             out_len=lognorm(1100, 0.18, z_weight=0.75),
                             par=lambda r, c: 1, next=then("exec")),
        "exec": UnitSpec("exec", _DOCKER, dur=uniform(6, 10, z_weight=0.8),
                         next=then("reflect")),
        "reflect": UnitSpec("reflect", _L("reflect", a, lora="coder"),
                            in_len=lognorm(1300, 0.3), out_len=lognorm(300, 0.35),
                            par=lambda r, c: 1,
                            next=loop("generate", 0.45, None, max_visits=4,
                                      z_weight=0.4, loop_from="generate")),
    }
    return AppSpec(a, "plan", units, "medium")


def _kbqav() -> AppSpec:  # Knowledge-Based-QA Verification (FacTool KBQA) — small
    a = "KBQAV"
    units = {
        "claims": UnitSpec("claims", _L("claims", a), in_len=lognorm(800, 0.3),
                           out_len=lognorm(100, 0.18, z_weight=0.7),
                           par=lambda r, c: 1, next=then("queries")),
        "queries": UnitSpec("queries", _L("queries", a),
                            in_len=lognorm(300, 0.3),
                            out_len=uniform(10, 50),    # the paper's example
                            par=uniform(3, 5, z_weight=0.5), next=then("search")),
        "search": UnitSpec("search", _SEARCH, dur=uniform(0.5, 2.0),
                           next=then("verify")),
        "verify": UnitSpec("verify", _L("verify", a),
                           in_len=lognorm(1500, 0.3),
                           out_len=lognorm(60, 0.3),
                           par=track("queries", "par"),  # one verify per query
                           next=then(None)),
    }
    return AppSpec(a, "claims", units, "small")


def _pe() -> AppSpec:  # Plan-and-Execution (HuggingGPT) — medium
    a = "PE"
    units = {
        "plan": UnitSpec("plan", _L("plan", a), in_len=lognorm(700, 0.3),
                         out_len=lognorm(200, 0.35, z_weight=0.5),
                         par=lambda r, c: 1,
                         next=branch([("tool-vit", 0.55), ("tool-diffusion", 0.2),
                                      ("summarize", 0.25)])),
        "tool-vit": UnitSpec("tool-vit", _VIT, dur=uniform(2, 6),
                             next=branch([("tool-vit", 0.2), ("tool-diffusion", 0.1),
                                          ("summarize", 0.7)])),
        "tool-diffusion": UnitSpec("tool-diffusion", _DIFF,
                                   dur=uniform(15, 40, z_weight=0.3),
                                   next=branch([("tool-vit", 0.15),
                                                ("summarize", 0.85)])),
        "summarize": UnitSpec("summarize", _L("summarize", a),
                              in_len=lognorm(900, 0.3), out_len=lognorm(250, 0.3),
                              par=lambda r, c: 1, next=then(None)),
    }
    return AppSpec(a, "plan", units, "medium")


SUITE: Dict[str, AppSpec] = {s.name: s for s in
                             (_dm(), _mrs(), _llmr(), _ev(), _fev(), _cc(),
                              _alfwi(), _cg(), _kbqav(), _pe())}

# §5.1 size mix: 72% small / 26% medium / 2% large (LLMR excluded, per paper)
MIX = {
    "small": (["EV", "FEV", "CC", "ALFWI", "KBQAV"], 0.72),
    "medium": (["CG", "PE"], 0.26),
    "large": (["DM", "MRS"], 0.02),
}


def sample_app_names(n: int, rng: np.random.Generator) -> List[str]:
    names, probs = [], []
    for cls, (apps, p) in MIX.items():
        for x in apps:
            names.append(x)
            probs.append(p / len(apps))
    probs = np.asarray(probs) / np.sum(probs)
    return [names[i] for i in rng.choice(len(names), size=n, p=probs)]


def build_knowledge_base(n_trials: int = 1000, seed: int = 7,
                         apps: Dict[str, AppSpec] = None) -> Dict[str, PDGraph]:
    """Offline profiling pass: n_trials generator runs per application."""
    out: Dict[str, PDGraph] = {}
    for i, (name, spec) in enumerate(sorted((apps or SUITE).items())):
        out[name] = profile_app(spec, n_trials, seed=seed + i)
    return out
