"""Persistence for profiled data: TaskKey -> (SK, SG) as JSON.

The paper loads profiling output into the scheduler's memory at startup;
this store is the on-disk format between the measurement and sharing
phases. Profiles refined by the ONLINE measurement loop
(``repro_torch.core.online``) round-trip losslessly too: per-kernel observation
counters (``obs``/``gap_obs``) and the EMA smoothing factor of the last
online update (``ema_alpha``) are written when present, so a serving
process can checkpoint its live-learned SK/SG state and resume smoothing
where it left off. Entries written by older versions (no online fields)
load with empty counters — the formats are mutually compatible.

Interference state (PR 6) rides the same store: a profile's per-kernel
resource classes are written as a ``class`` entry field when present, and
when the ``ProfiledData`` carries an attached
``repro_torch.core.interference.InterferenceModel`` the file becomes a dict
``{"profiles": [...], "interference": {...}}`` so learned coefficients
checkpoint and resume with the profiles. Plain stores keep the original
top-level list format, and pre-classification files (no ``class`` field)
load with every kernel defaulting to compute-bound — both pinned by test.
"""
from __future__ import annotations

import json
import os

from repro_torch.core.interference import InterferenceModel
from repro_torch.core.kernel_id import KernelID
from repro_torch.core.profiler import ProfiledData, TaskProfile
from repro_torch.core.task import TaskKey


def _kid_to_json(kid: KernelID) -> list:
    return [kid.name, list(kid.grid), list(kid.block)]


def _kid_from_json(j) -> KernelID:
    return KernelID(j[0], tuple(_detuple(x) for x in j[1]),
                    tuple(_detuple(x) for x in j[2]))


def _detuple(x):
    return tuple(x) if isinstance(x, list) else x


def profiles_to_obj(data: ProfiledData):
    """Serialize a ``ProfiledData`` to the store's JSON-compatible object
    (a list, or a dict envelope when an interference model is attached).
    ``save_profiles`` writes this to a file; ``repro_torch.core.jobstore`` embeds
    it in the durable job store's profile-snapshot column."""
    out = []
    for key, prof in data._by_key.items():
        entry = {
            "process": key.process,
            "args": list(key.args),
            "runs": prof.runs,
            "SK": [[_kid_to_json(k), v] for k, v in prof.SK.items()],
            "SG": [[_kid_to_json(k), v] for k, v in prof.SG.items()],
        }
        # online-measurement state: only written when the profile carries
        # any, so purely-offline stores keep the original compact format
        if prof.obs_count:
            entry["obs"] = [[_kid_to_json(k), n]
                            for k, n in prof.obs_count.items()]
        if prof.gap_obs_count:
            entry["gap_obs"] = [[_kid_to_json(k), n]
                                for k, n in prof.gap_obs_count.items()]
        if prof.ema_alpha is not None:
            entry["ema_alpha"] = prof.ema_alpha
        if prof.kclass:
            entry["class"] = [[_kid_to_json(k), c]
                              for k, c in prof.kclass.items()]
        out.append(entry)
    model = getattr(data, "interference", None)
    if model is not None:
        # dict envelope only when there is a model to checkpoint; plain
        # stores keep the original top-level list format
        out = {"profiles": out,
               "interference": {
                   "enabled": model.enabled,
                   "coeffs": [[h, f, v]
                              for (h, f), v in model.snapshot().items()],
               }}
    return out


def save_profiles(path: str, data: ProfiledData) -> None:
    out = profiles_to_obj(data)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)


def profiles_from_obj(raw, cold_start: bool = False) -> ProfiledData:
    """Rebuild a ``ProfiledData`` from ``profiles_to_obj`` output (or any
    legacy top-level-list store payload)."""
    data = ProfiledData(cold_start=cold_start)
    entries = raw
    if isinstance(raw, dict):
        entries = raw["profiles"]
        imeta = raw.get("interference")
        if imeta is not None:
            data.interference = InterferenceModel(
                {(h, f): v for h, f, v in imeta.get("coeffs", [])},
                enabled=imeta.get("enabled", True))
    for entry in entries:
        key = TaskKey(entry["process"], tuple(entry["args"]))
        prof = TaskProfile(key=key, runs=entry["runs"],
                           ema_alpha=entry.get("ema_alpha"))
        prof.SK = {_kid_from_json(k): v for k, v in entry["SK"]}
        prof.SG = {_kid_from_json(k): v for k, v in entry["SG"]}
        prof.obs_count = {_kid_from_json(k): n
                          for k, n in entry.get("obs", [])}
        prof.gap_obs_count = {_kid_from_json(k): n
                              for k, n in entry.get("gap_obs", [])}
        prof.kclass = {_kid_from_json(k): c
                       for k, c in entry.get("class", [])}
        data.load(prof)
    return data


def load_profiles(path: str, cold_start: bool = False) -> ProfiledData:
    """Load a profile store. ``cold_start=True`` builds the returned
    ``ProfiledData`` with the provisional-duration estimator enabled (the
    online serving configuration)."""
    if not os.path.exists(path):
        return ProfiledData(cold_start=cold_start)
    with open(path) as f:
        raw = json.load(f)
    return profiles_from_obj(raw, cold_start=cold_start)
