"""BY001: dispatcher-bypass lint over the model / serving layer (port of
``repro.analysis.bypass_lint``).

Every GEMM-shaped product is supposed to flow through
:func:`repro_torch.tune.dispatch.resolve` so the policy / registry
machinery can route it onto the tuned kernel. The model zoo and the
attention / SSD kernels predate that discipline: their products are raw.
This lint keeps that debt visible and monotone: it runs the reference's
entry points (``model_zoo.forward`` / ``decode_step`` per architecture
family, the serving prefill, and the two standalone kernels) once on fake
CUDA tensors - the card route, so B5 and B6 appear as launches, as the
reference's walk sees ``_attn_kernel`` and ``_ssd_kernel`` - and names the
site of every raw contraction: the innermost ``repro_torch`` frame of an
``aten.mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``convolution``, or the
wrapper of a B5 or B6 launch. Sites under
:data:`repro_torch.tune.dispatch.DISPATCHED_MODULES` are dispatched by
construction; every other site is a bypass and must be on the committed
burn-down allowlist (``bypass_allowlist.json``) with a reason. A new site
fails the sweep; removing an entry as code moves onto the dispatcher is
the burn-down. Each entry also names the reference site it corresponds to
(``"reference"``) or the difference that leaves it without one
(``"difference"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import fake_card, rules
from repro_torch.analysis.rules import Finding, make_finding

# the contraction ops the dispatcher exists to route, and the kernels whose
# launches stand for the reference's raw contractions inside a kernel body
CONTRACTION_OPS = fake_card.CONTRACTIONS
BYPASS_KERNELS = ("attention", "ssd_scan")

# one representative architecture per model family
BYPASS_ARCHS = ("gemma-7b", "whisper-small", "mamba2-130m", "hymba-1.5b",
                "internvl2-1b", "qwen3-moe-235b-a22b")

DEFAULT_ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__),
                                      "bypass_allowlist.json")

_CARD = torch.device("cuda")


# ------------------------------ entry points --------------------------------

def _reduced(arch: str):
    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    cfg = reduce_config(registry.get_config(arch), layers=2, d_model=64,
                        vocab=128, heads=4)
    return dataclasses.replace(cfg, accum_steps=1, dtype="float32")


def _model(cfg):
    from repro_torch.models import model_zoo as zoo
    return zoo.build(cfg, device=_CARD)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    """A fake CUDA tensor of ``t``'s shape and dtype (inside the mode)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype, device=_CARD)


def _batch(cfg, batch: int = 4, seq: int = 16):
    """The reference's batch shapes (``make_batch`` on the CPU, outside
    the fake mode), as fake CUDA tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.data.pipeline import DataConfig, make_batch
    with unset_fake_temporarily():
        real = make_batch(cfg, DataConfig(vocab=cfg.vocab,
                                          global_batch=batch, seq_len=seq),
                          0, device="cpu")
    return {k: _on_card(t) for k, t in real.items()}


def _forward_entry(arch: str):
    def build():
        from repro_torch.models import model_zoo as zoo
        cfg = _reduced(arch)
        return (lambda m, b: zoo.forward(m, b, cfg)), \
            (_model(cfg), _batch(cfg)), {}
    return build


def _decode_entry(arch: str):
    def build():
        from repro_torch.models import model_zoo as zoo
        cfg = _reduced(arch)
        model = _model(cfg)
        b = 2
        memory = None
        if cfg.family == "encdec":
            memory = torch.zeros((b, 8, cfg.d_model), dtype=torch.float32,
                                 device=_CARD)
        caches = zoo.init_caches(model, cfg, b, 24, memory=memory,
                                 dtype=torch.float32)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=_CARD)
        return (lambda m, t, c: zoo.decode_step(m, t, cfg, c, 0)), \
            (model, tok, caches), {}
    return build


def _serve_entry():
    def build():
        # launch/serve.py's compute path
        from repro_torch.models import model_zoo as zoo
        cfg = _reduced("mamba2-130m")
        return (lambda m, b: zoo.prefill(m, b, cfg)), \
            (_model(cfg), _batch(cfg)), {}
    return build


def _normal(*shape):
    return torch.empty(shape, dtype=torch.float32, device=_CARD)


def _attention_entry():
    def build():
        from repro_torch.kernels.flash_attention import attention
        q, k, v = (_normal(2, 2, 32, 16) for _ in range(3))
        return attention, (q, k, v), {}
    return build


def _ssd_entry():
    def build():
        from repro_torch.kernels.ssd_scan import ssd_scan
        x = _normal(2, 2, 32, 4)
        a_log = -_normal(2, 2, 32).abs()
        B, C = _normal(2, 2, 32, 4), _normal(2, 2, 32, 4)
        return ssd_scan, (x, a_log, B, C), {}
    return build


def default_entries() -> List[Tuple[str, Callable]]:
    """(name, build) per lintable entry point; each ``build`` runs lazily
    (inside the fake mode) so one broken family cannot stop the others from
    being collected."""
    entries: List[Tuple[str, Callable]] = []
    for arch in BYPASS_ARCHS:
        entries.append((f"zoo.forward[{arch}]", _forward_entry(arch)))
        entries.append((f"zoo.decode_step[{arch}]", _decode_entry(arch)))
    entries.append(("serve.prefill", _serve_entry()))
    entries.append(("kernels.flash_attention", _attention_entry()))
    entries.append(("kernels.ssd_scan", _ssd_entry()))
    return entries


# --------------------------- site classification ----------------------------

def _is_dispatched(site: str) -> bool:
    from repro_torch.tune.dispatch import DISPATCHED_MODULES
    path = site.split(":", 1)[0]
    return any(path.startswith(p) for p in DISPATCHED_MODULES)


def entry_sites(tr: fake_card.Trace) -> List[Tuple[str, str]]:
    """(site, op) of every contraction and B5 / B6 launch of one run."""
    out = [(s or f"<unknown>:{op}", op) for s, op in tr.contractions]
    out += [(rec["site"], f"launch:{rec['kernel']}") for rec in tr.launches
            if rec["kernel"] in BYPASS_KERNELS]
    return out


def collect_bypass_sites(entries: Optional[Sequence[Tuple[str, Callable]]]
                         = None, progress: Optional[Callable] = None
                         ) -> "Tuple[OrderedDict, List[Dict]]":
    """Run every entry on the fake card and attribute its contractions.

    Returns ``(sites, cases)``: ``sites`` maps each *bypass* site key
    (``repro_torch/<file>:<function>``) to ``{"primitives", "count",
    "entries"}``; ``cases`` records per-entry totals (including entries
    that failed to build, so a broken family is visible, not silent).
    """
    entries = default_entries() if entries is None else list(entries)
    sites: "OrderedDict[str, Dict]" = OrderedDict()
    cases: List[Dict] = []
    for name, build in entries:
        if progress is not None:
            progress(name)
        try:
            tr = fake_card.run(build, _CARD)
        except Exception as exc:
            cases.append({"entry": name, "error":
                          f"{type(exc).__name__}: {exc}"})
            continue
        contractions = bypasses = 0
        for site, op in entry_sites(tr):
            contractions += 1
            if _is_dispatched(site):
                continue
            bypasses += 1
            rec = sites.setdefault(site, {"primitives": set(), "count": 0,
                                          "entries": set()})
            rec["primitives"].add(op)
            rec["count"] += 1
            rec["entries"].add(name)
        cases.append({"entry": name, "contractions": contractions,
                      "bypasses": bypasses})
    for rec in sites.values():
        rec["primitives"] = sorted(rec["primitives"])
        rec["entries"] = sorted(rec["entries"])
    return sites, cases


# ------------------------------- allowlist ----------------------------------

def load_bypass_allowlist(path: Optional[str] = DEFAULT_ALLOWLIST_PATH
                          ) -> Dict[str, str]:
    """``{site: reason}`` from the burn-down file; registry convention.

    Missing file -> silently empty (cold start: every bypass fires).
    Corrupt / wrong-schema file -> ``RuntimeWarning`` once per path and
    treated as empty, so breakage re-fires findings, never hides one.
    """
    if path is None or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            raw = json.load(f)
        if int(raw.get("schema_version", -1)) != rules.SCHEMA_VERSION:
            raise ValueError(f"schema_version {raw.get('schema_version')!r}"
                             f" != {rules.SCHEMA_VERSION}")
        if raw.get("rule") != "BY001":
            raise ValueError(f"rule {raw.get('rule')!r} != 'BY001'")
        return {str(e["site"]): str(e.get("reason", ""))
                for e in raw["sites"]}
    except Exception as exc:
        if path not in rules._warned_paths:
            rules._warned_paths.add(path)
            warnings.warn(f"bypass allowlist {path!r} is corrupt ({exc}); "
                          "treating as empty", RuntimeWarning, stacklevel=2)
        return {}


def save_bypass_allowlist(sites: Dict[str, Dict], path: str,
                          reason: str = "pre-dispatcher site; burn down"
                          ) -> str:
    """Write the burn-down file for the current bypass set (the reference
    and difference fields of entries already in ``path`` are kept)."""
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = {e["site"]: e for e in json.load(f).get("sites", [])}
    payload = {"schema_version": rules.SCHEMA_VERSION, "rule": "BY001",
               "sites": []}
    for s, info in sorted(sites.items()):
        e = {"site": s, "reason": old.get(s, {}).get("reason", reason),
             "primitives": info["primitives"], "entries": info["entries"]}
        for key in ("reference", "difference"):
            if key in old.get(s, {}):
                e[key] = old[s][key]
        payload["sites"].append(e)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# --------------------------------- the lint ---------------------------------

def lint_bypass(entries: Optional[Sequence[Tuple[str, Callable]]] = None,
                allowlist: Optional[str] = DEFAULT_ALLOWLIST_PATH,
                progress: Optional[Callable] = None):
    """BY001 over the model / serving / kernel entry points ->
    AnalysisReport.

    One finding per unique bypass site; sites on the committed allowlist
    land in ``report.suppressed`` (tagged ``allowlist:<path>``), so
    ``report.ok`` fails exactly when a *new* bypass appears.
    """
    from repro_torch.analysis.report import AnalysisReport
    sites, cases = collect_bypass_sites(entries, progress=progress)
    allowed = load_bypass_allowlist(allowlist)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for site, info in sites.items():
        f = make_finding(
            "BY001", f"raw {'/'.join(info['primitives'])} at {site} "
            f"({info['count']} call(s), reachable from "
            f"{', '.join(info['entries'])}) never passes "
            "tune.dispatch.resolve",
            routine=info["entries"][0], location=site,
            case={"entries": info["entries"]})
        if site in allowed:
            suppressed.append(dataclasses.replace(
                f, suppressed=True, suppressed_by=f"allowlist:{allowlist}"))
        else:
            active.append(f)
    return AnalysisReport("dispatcher-bypass", cases, active, suppressed)
