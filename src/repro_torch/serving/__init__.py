"""Serving package: engine-hosted services (``repro.serving`` in the JAX
package). The admission plane and the worker fleet come in a later
slice."""
from repro_torch.serving.engine import InferenceService, ServingSystem  # noqa: F401
