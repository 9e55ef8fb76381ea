"""Segmentation: split a model's forward pass into dispatchable "kernels"
(program segments) for the FIKIT scheduler (``repro.models.segmentation``).

A service's inference = [embed] + [layer]*L + [head]. The layer segment is
ONE callable reused for every layer (the layer's module is bound per
segment), so all L dispatches share a KernelID, as in the paper's Fig 5.

Host work (sampling) runs client-side between segments — the origin of
inter-kernel device idle gaps. Each segment body runs under
``torch.inference_mode()``, entered inside the segment because that mode
is thread-local and segments run on the engine's device thread, and ends
in ``torch.cuda.synchronize()`` on a CUDA device: without it the engine
would time kernel launches, not kernels, and SK would mean nothing.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.client import Segment
from repro_torch.models import api
from repro_torch.models import transformer as tfm


def _sync(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def _sleep_work(seconds: float) -> Optional[Callable]:
    if seconds <= 0:
        return None

    def work(state):
        time.sleep(seconds)
        return state
    return work


class SegmentedService:
    """A model packaged as FIKIT-schedulable segments.

    host_gap: host think-time injected after each layer segment (models
    the CPU-side work real serving stacks do between dispatches).
    """

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, batch: int,
                 seq: int, host_gap: float = 0.0, tail_gap: float = 0.0):
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.batch = batch
        self.seq = seq
        self.host_gap = host_gap
        self.tail_gap = tail_gap
        self._build_decoder_lm()

    def _build_decoder_lm(self):
        cfg, model = self.cfg, self.model

        def embed(tokens):
            with torch.inference_mode():
                return _sync(tfm.embed_tokens(model, tokens, cfg))

        def head(x):
            with torch.inference_mode():
                return _sync(tfm.unembed(model, x, cfg))

        segs = [Segment(f"{cfg.name}/embed", embed)]
        for lp in model.layers:
            segs.append(Segment(
                f"{cfg.name}/layer",
                partial(self._run_layer, lp, cfg),
                host_work=_sleep_work(self.host_gap)))
        segs.append(Segment(f"{cfg.name}/head", head,
                            host_work=self._sample_work()))
        self.segments = segs

    @staticmethod
    def _run_layer(lp: tfm.DecoderLayer, cfg: ModelConfig, x):
        with torch.inference_mode():
            return _sync(tfm.layer_apply(lp, x, tfm.positions_for(x), cfg,
                                         window=cfg.sliding_window,
                                         chunk=cfg.attention_chunk))

    def _sample_work(self):
        tail = self.tail_gap

        def work(logits):
            # host-side sampling: argmax -> numpy ints (detokenize analog)
            toks = logits[..., :64].argmax(dim=-1).cpu().numpy()
            if tail > 0:
                time.sleep(tail)
            return toks
        return work

    def make_input(self, generator: Optional[torch.Generator] = None):
        return api.make_batch(self.cfg, self.batch, self.seq, generator,
                              device=self.device)

    def warmup(self):
        """Run every segment once outside any measurement (on a CUDA
        device this builds the kernels and the library handles)."""
        state = self.make_input()
        for seg in self.segments:
            state = seg.fn(state)
        return True
