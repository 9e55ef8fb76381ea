"""SK of the high service's ``layer`` KernelID after onboarding, read as
``hi_layer_sk_ms`` reads it, in a cell where it sets, with its SG, which
low layers fill the high gaps."""
from servebench.catalog import load_metric

read = load_metric("hi_layer_sk_ms")
