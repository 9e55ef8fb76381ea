"""A run on the CPU at reduced size with the timed path broken underneath
must come out not correct; the same run unbroken comes out correct. The
look for a card is skipped (``run_cell`` on the CPU); everything else of
a run happens: set-up, onboarding, the window through the admission
plane, the outputs check against the cell's own limits. One chip has no
exchange between chips, so that fault has no case here."""
import pytest
import torch

from conftest import reduced
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm
from servebench import harness

SEED = 2 ** 31 + 4242


def unchanged(fn):
    """A layer that returns its state unchanged."""
    def layer(lp, x, *a, **k):
        return x
    return layer


def half_batch(fn):
    """A layer computed for the first half of the batch only."""
    def layer(lp, x, *a, **k):
        h = x.shape[0] // 2
        return torch.cat([fn(lp, x[:h], *a, **k), x[h:]])
    return layer


def altered_answer(fn):
    """The head's logits with one position's least likely token made its
    most likely."""
    def unembed(model, x, cfg):
        y = fn(model, x, cfg).clone()
        y[0, 1, y[0, 1].argmin()] = y[0, 1].max() + 1.0
        return y
    return unembed


def sound(fn):
    return fn


FAULTS = {"sound": ("layer", sound), "unchanged": ("layer", unchanged),
          "half_batch": ("layer", half_batch),
          "altered_answer": ("head", altered_answer)}


def run(cell_name, monkeypatch, where, breaker):
    if where == "layer":
        monkeypatch.setattr(tfm, "layer_apply", breaker(tfm.layer_apply))
        # the SSM's segments bind mamba2.layer_apply when built
        monkeypatch.setattr(mamba2, "layer_apply",
                            breaker(mamba2.layer_apply))
    else:
        monkeypatch.setattr(tfm, "unembed", breaker(tfm.unembed))
    cfgs, mix = reduced(cell_name)
    return harness.run_cell(cell_name, SEED, 1.5, False, device="cpu",
                            cfg_override=cfgs, mix_override=mix)


@pytest.mark.parametrize("cell_name", ["F.fill", "A.long_docs"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_not_correct(cell_name, fault, monkeypatch):
    out = run(cell_name, monkeypatch, *FAULTS[fault])
    assert out["attempted"] > 0 and out["failed"] == 0
    gaps = {k: v["value"] for k, v in out["compared"].items()}
    if fault == "sound":
        assert out["correct"], gaps
    else:
        assert not out["correct"], gaps
