"""What the port's span recorder (``repro_torch.spans``) costs: the host
time a device thread spends on one row (the extra clock reads, the
issued mark and its take, the row and its append), and the memory of a
full ring of rows as the engine makes them.

    PYTHONPATH=src python scripts/torch_spans_cost.py

Prints one JSON line. The time is host time, so run it on the machine
that serves.
"""
import json
import statistics
import sys
import time
import tracemalloc

from repro_torch import spans

ROWS = 200_000
REPEATS = 5


def one_row(i: int) -> None:
    """What ``WallClockEngine._device_loop`` adds for one request."""
    now = time.perf_counter
    asked = now()
    got = now()
    spans.mark_issued()
    issued = spans.take_issued(got)
    booked = now()
    spans.record((0, 1_000_000 + i // 26, i % 26, 5, False, "model/layer",
                  asked, asked, got, got, issued, booked, booked, now()))


def us_per_row() -> float:
    spans.clear()
    t = time.perf_counter()
    for i in range(ROWS):
        one_row(i)
    return 1e6 * (time.perf_counter() - t) / ROWS


def ring_bytes() -> int:
    spans.clear()
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for i in range(spans.CAPACITY):
        one_row(i)
    held = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    return held


def main() -> int:
    times = [us_per_row() for _ in range(REPEATS)]
    full = ring_bytes()
    spans.clear()
    print(json.dumps({"us_per_row": statistics.median(times),
                      "us_per_row_runs": times, "capacity": spans.CAPACITY,
                      "ring_bytes": full,
                      "python": sys.version.split()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
