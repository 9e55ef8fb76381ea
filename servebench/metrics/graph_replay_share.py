"""Per cent of the CUDA segment calls since the process started that
replayed a captured graph, over those replayed and those run eagerly
(the calls that captured one): the port's counter beside its span ring
(``repro_torch.spans.graph_counts``). None where the program has no such
counter or ran no CUDA segment."""


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counts = getattr(spans, "graph_counts", None)
    if counts is None:
        return None
    c = counts()
    n = c["replayed"] + c["eager"]
    return 100.0 * c["replayed"] / n if n else None
