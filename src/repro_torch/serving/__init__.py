"""Serving package: engine-hosted services, admission plane, workers.

Imports are lazy (PEP 562): ``repro_torch.serving.engine`` pulls in
torch and the model zoo, which an engine-worker subprocess (``python -m
repro_torch.serving.workers``) and the store-only verbs of
``repro_torch.launch.serve`` never need — resolving names on first
access keeps their start-up to the pure-python scheduler core.
"""
_LAZY = {
    "InferenceService": ("repro_torch.serving.engine", "InferenceService"),
    "ServingSystem": ("repro_torch.serving.engine", "ServingSystem"),
    "AdmissionPlane": ("repro_torch.serving.admission", "AdmissionPlane"),
    "AdmissionTicket": ("repro_torch.serving.admission", "AdmissionTicket"),
    "QoSClass": ("repro_torch.serving.admission", "QoSClass"),
    "DEFAULT_CLASSES": ("repro_torch.serving.admission", "DEFAULT_CLASSES"),
    "EngineWorker": ("repro_torch.serving.workers", "EngineWorker"),
    "WorkerConfig": ("repro_torch.serving.workers", "WorkerConfig"),
    "WorkerSupervisor": ("repro_torch.serving.workers", "WorkerSupervisor"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value          # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
