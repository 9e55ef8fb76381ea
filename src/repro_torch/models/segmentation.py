"""Segmentation: split a model's forward pass into dispatchable "kernels"
(program segments) for the FIKIT scheduler (``repro.models.segmentation``).

A service's inference = [embed] + [layer]*L + [head]. The layer segment is
ONE callable reused for every layer (the layer's module is bound per
segment), so all L dispatches share a KernelID, as in the paper's Fig 5:
a dense decoder layer (also the VLM's), an MoE layer (its window and
chunk chosen by the layer's index: llama4's every 4th layer is full
attention; its aux loss is dropped), or a mamba2 SSD mixer layer for the
SSM family. The hybrid (recurrentgemma) has one ``rec`` and one
``attn`` segment kind instead of ``layer``, in its block pattern's order.
The encoder-decoder (seamless-m4t) runs ``encode`` (the token embedding
and the whole encoder; its state is the tuple (encoder output, decoder
activations)), one ``dec_layer`` per decoder layer, and ``head``. The
VLM's ``embed`` takes the (patches, tokens) batch and builds the stub
patches inside the segment, as the JAX package's embed segment means to
(its own reads ``.shape`` of the tuple and fails).

Host work (sampling) runs client-side between segments — the origin of
inter-kernel device idle gaps. Each segment body runs under
``torch.inference_mode()``, entered inside the segment because that mode
is thread-local and segments run on the engine's device thread, and ends
in ``torch.cuda.synchronize()`` on a CUDA device: without it the engine
would time kernel launches, not kernels, and SK would mean nothing. On a
CUDA device the body is replayed from a CUDA graph per segment instance
and input signature (``models.graphs``), one memory pool a service; on
the CPU it runs eagerly.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional, Union

import torch

from repro_torch import spans
from repro_torch.config import ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.core.client import Segment
from repro_torch.models import api, encdec, mamba2, moe, rglru, vlm
from repro_torch.models import transformer as tfm
from repro_torch.models.graphs import Graphed, SegmentGraphs


def _sync(state):
    """Wait for the card to finish ``state`` (a tensor, or a tuple of
    tensors on one device). Called with the segment's body as its
    argument, so it starts when the last kernel has been issued: that
    moment is stamped for the engine's span recorder."""
    spans.mark_issued()
    t = state[0] if isinstance(state, tuple) else state
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return state


class _Call:
    """A segment's callable: its body under inference mode, through the
    service's graphs, then ``_sync``; ``pick`` takes the part of the state
    the body reads. ``eager`` runs the body as it is, for comparisons with
    the replay."""

    def __init__(self, graphed: Graphed, pick: Optional[Callable] = None):
        self.graphed = graphed
        self.pick = pick

    def __call__(self, state):
        return self._run(self.graphed, state)

    def eager(self, state):
        return self._run(self.graphed.body, state)

    def _run(self, fn, state):
        if self.pick is not None:
            state = self.pick(state)
        with torch.inference_mode():
            return _sync(fn(state))


def _block(fn, lp, cfg: ModelConfig, x):
    return fn(lp, x, cfg)


def _dense_layer(lp: tfm.DecoderLayer, x, cfg: ModelConfig):
    return tfm.layer_apply(lp, x, tfm.positions_for(x), cfg,
                           window=cfg.sliding_window,
                           chunk=cfg.attention_chunk)


def _dec_layer(lp: encdec.DecoderLayer, state, cfg: ModelConfig):
    """One encoder-decoder decoder layer over the state (encoder output,
    decoder activations)."""
    enc_out, x = state
    return enc_out, encdec._dec_layer(lp, x, tfm.positions_for(x), enc_out,
                                      cfg)


def _moe_layer(lp: moe.MoELayer, x, cfg: ModelConfig, *, window, chunk):
    y, _aux = moe.layer_apply(lp, x, tfm.positions_for(x), cfg,
                              window=window, chunk=chunk)
    return y


def layer_fn(cfg: ModelConfig, index: int) -> Callable:
    """The forward pass of layer ``index`` of a dense, MoE or SSM model,
    as ``fn(layer_module, x, cfg)``."""
    if cfg.family == SSM:
        return mamba2.layer_apply
    if cfg.family == MOE:
        window, chunk = moe.layer_kinds(cfg)[index]
        return partial(_moe_layer, window=window, chunk=chunk)
    return _dense_layer


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

    def __init__(self, cfg: ModelConfig,
                 model: Union[tfm.Transformer, moe.MoEModel, mamba2.Mamba2,
                              rglru.Hybrid, encdec.EncDec],
                 batch: int, seq: int, host_gap: float = 0.0,
                 tail_gap: float = 0.0):
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.batch = batch
        self.seq = seq
        self.host_gap = host_gap
        self.tail_gap = tail_gap
        self.graphs = SegmentGraphs()
        if cfg.family == HYBRID:
            self._build_hybrid()
        elif cfg.family == ENCDEC:
            self._build_encdec()
        else:
            self._build_decoder_lm()

    def _call(self, body: Callable, pick: Optional[Callable] = None):
        return _Call(Graphed(body, self.graphs), pick)

    def _layer(self, name: str, fn, lp) -> Segment:
        return Segment(f"{self.cfg.name}/{name}",
                       self._call(partial(_block, fn, lp, self.cfg)),
                       host_work=_sleep_work(self.host_gap))

    def _ends(self):
        """The embed and head segments, shared by the decoder-LM and hybrid
        layouts."""
        cfg, model = self.cfg, self.model

        def embed(tokens):
            patches = None
            if cfg.family == VLM:
                patches = vlm.stub_patches(cfg, tokens.shape[0],
                                           device=tokens.device)
            return tfm.embed_tokens(model, tokens, cfg, patches)

        # the VLM's batch is (stub patches, tokens): the segment builds
        # its patches itself
        pick = (lambda batch: batch[1]) if cfg.family == VLM else None
        return (Segment(f"{cfg.name}/embed", self._call(embed, pick)),
                self._head())

    def _head(self, pick: Optional[Callable] = None) -> Segment:
        """The head segment: the logits of ``pick(state)``."""
        cfg, model = self.cfg, self.model
        return Segment(f"{cfg.name}/head",
                       self._call(lambda x: tfm.unembed(model, x, cfg), pick),
                       host_work=self._sample_work())

    def _build_decoder_lm(self):
        cfg = self.cfg
        embed, head = self._ends()
        self.segments = ([embed] + [self._layer("layer", layer_fn(cfg, i), lp)
                                    for i, lp in enumerate(self.model.layers)]
                         + [head])

    def _build_hybrid(self):
        embed, head = self._ends()
        self.segments = [embed] + [
            self._layer(kind, rglru.rec_block_apply if kind == "rec"
                        else rglru.attn_block_apply, lp)
            for lp, kind in zip(self.model.blocks,
                                rglru.block_kinds(self.cfg))] + [head]

    def _build_encdec(self):
        cfg, model = self.cfg, self.model

        def encode(batch):
            frames, tokens = batch
            return (encdec.encode(model, frames, cfg),
                    tfm.embed_tokens(model, tokens, cfg))

        self.segments = ([Segment(f"{cfg.name}/encode", self._call(encode))]
                         + [self._layer("dec_layer", _dec_layer, lp)
                            for lp in model.dec_layers]
                         + [self._head(lambda state: state[1])])

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
        device this builds the kernels and the library handles and
        captures each segment's graph)."""
        state = self.make_input()
        for seg in self.segments:
            state = seg.fn(state)
        return True
