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
would time kernel launches, not kernels, and SK would mean nothing.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional, Union

import torch

from repro_torch.config import ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.core.client import Segment
from repro_torch.models import api, encdec, mamba2, moe, rglru, vlm
from repro_torch.models import transformer as tfm


def _sync(state):
    """Wait for the card to finish ``state`` (a tensor, or a tuple of
    tensors on one device)."""
    t = state[0] if isinstance(state, tuple) else state
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return state


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
        if cfg.family == HYBRID:
            self._build_hybrid()
        elif cfg.family == ENCDEC:
            self._build_encdec()
        else:
            self._build_decoder_lm()

    def _ends(self):
        """The embed and head segments, shared by the decoder-LM and hybrid
        layouts."""
        cfg, model = self.cfg, self.model

        def embed(batch):
            with torch.inference_mode():
                if cfg.family != VLM:
                    return _sync(tfm.embed_tokens(model, batch, cfg))
                tokens = batch[1]
                patches = vlm.stub_patches(cfg, tokens.shape[0],
                                           device=tokens.device)
                return _sync(tfm.embed_tokens(model, tokens, cfg, patches))

        return Segment(f"{cfg.name}/embed", embed), self._head(lambda x: x)

    def _head(self, activations: Callable) -> Segment:
        """The head segment: the logits of ``activations(state)``."""
        cfg, model = self.cfg, self.model

        def head(state):
            with torch.inference_mode():
                return _sync(tfm.unembed(model, activations(state), cfg))

        return Segment(f"{cfg.name}/head", head,
                       host_work=self._sample_work())

    def _build_decoder_lm(self):
        cfg = self.cfg
        embed, head = self._ends()
        segs = [embed]
        for i, lp in enumerate(self.model.layers):
            segs.append(Segment(
                f"{cfg.name}/layer",
                partial(self._run_block, layer_fn(cfg, i), lp, cfg),
                host_work=_sleep_work(self.host_gap)))
        self.segments = segs + [head]

    def _build_hybrid(self):
        cfg = self.cfg
        embed, head = self._ends()
        segs = [embed]
        for lp, kind in zip(self.model.blocks, rglru.block_kinds(cfg)):
            fn = (rglru.rec_block_apply if kind == "rec"
                  else rglru.attn_block_apply)
            segs.append(Segment(
                f"{cfg.name}/{kind}", partial(self._run_block, fn, lp, cfg),
                host_work=_sleep_work(self.host_gap)))
        self.segments = segs + [head]

    def _build_encdec(self):
        cfg, model = self.cfg, self.model

        def encode(batch):
            frames, tokens = batch
            with torch.inference_mode():
                return _sync((encdec.encode(model, frames, cfg),
                              tfm.embed_tokens(model, tokens, cfg)))

        segs = [Segment(f"{cfg.name}/encode", encode)]
        for lp in model.dec_layers:
            segs.append(Segment(
                f"{cfg.name}/dec_layer",
                partial(self._run_block, _dec_layer, lp, cfg),
                host_work=_sleep_work(self.host_gap)))
        self.segments = segs + [self._head(lambda state: state[1])]

    @staticmethod
    def _run_block(fn, lp, cfg: ModelConfig, x):
        with torch.inference_mode():
            return _sync(fn(lp, x, cfg))

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
