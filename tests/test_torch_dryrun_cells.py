"""The dry run's repaired cells (``repro_torch.launch.dryrun.lm_cell``),
each at the smallest size that shows its fault, on the CPU.

* A vocabulary that does not divide the model axis (mamba2-130m's 50,280
  and hymba-1.5b's 32,001 over 16): the head splits d over the model
  axis and its logits are partial sums.  Left so, DTensor split the
  loss's sequence over the model axis, and the flatten of (B, S) in the
  head's backward gave a ``_StridedShard`` that its ``bmm`` rule could
  not propagate under fake tensors.  The smallest case found: reduced
  mamba2-130m with one layer and a vocabulary of 67 on a (1, 4) mesh,
  B 2 x S 8.
* The blocked attention's backward keeps one chunk's scores at a time:
  a one-layer reduced tinyllama-1.1b train step at B 1 x S 2560 (past
  ``BLOCK_THRESHOLD``; 2.5 key chunks, so the last is padded) on one
  device holds less ``temp`` than one layer's float32 scores,
  B x H x S x T x 4 bytes (104,857,600).  Without the per-chunk
  recompute it holds 406,891,784.
* The loss on logits split over the vocabulary reduces over each
  rank's block (F4): a reduced tinyllama-1.1b train cell on (1, 4) with
  a vocabulary of 4,096, B 2 x S 256, all-gathers less, and holds less
  ``temp``, than one whole float32 copy of its logits, B x S x V x 4
  bytes (8,388,608).  Replicating them to take ``logsumexp`` it
  all-gathered 9,371,648 and held 21,609,216.
* A batch of one on a (1, 1) mesh trains (F5): torch's ``einsum``
  moved the batch dim of size 1, split over the data axis of size 1,
  with a ``permute``, and DTensor could not propagate that split
  through the ``view`` that followed.  The smallest case: one-layer
  reduced tinyllama-1.1b at B 1 x S 1; at S 2 and more it failed at
  ``aten.view(Spec(bf16[S, 64, 1, 1, 1](S(2)R)), [1, S, 64])``.
* A decode cell on (2, 2) gathers no weight whole: its all-gathers come
  to less than one copy of the parameters, and the largest is at most
  the largest leaf's share of the model axis (the data-axis gather of
  FSDP).  The data-parallel decode it replaces gathered every weight
  whole.
"""
import dataclasses
import math

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import api

torch.set_num_threads(1)


def test_vocab_that_does_not_divide_the_model_axis_trains():
    cfg = dataclasses.replace(registry.reduced("mamba2-130m"), vocab=67,
                              n_layers=1)
    rec = dryrun.lm_cell("mamba2-130m", ShapeSpec("x", 8, 2, "train"),
                         ((1, 4), ("data", "model")), cfg=cfg)
    assert "error" not in rec and rec["flops"] > 0
    assert rec["mem"]["argument"] == sum(rec["argument_parts"].values())


def test_blocked_attention_backward_holds_one_chunk_of_scores():
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"), n_layers=1,
                              compute_dtype="bfloat16")
    b, s = 1, 2560
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", s, b, "train"),
                         None, cfg=cfg)
    assert rec["mesh"] == "one" and rec["devices"] == 1
    one_layer_scores = b * cfg.n_heads * s * s * 4
    assert rec["mem"]["temp"] < one_layer_scores, rec["mem"]


def test_loss_gathers_no_logits_on_a_split_vocabulary():
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"), vocab=4096)
    b, s = 2, 256
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", s, b, "train"),
                         ((1, 4), ("data", "model")), cfg=cfg)
    whole = b * s * cfg.vocab * 4
    assert rec["collective_bytes"]["all-gather"] < whole, rec
    assert rec["mem"]["temp"] < whole, rec["mem"]


@pytest.mark.parametrize("s", [1, 2])
def test_batch_of_one_on_a_unit_mesh_trains(s):
    cfg = dataclasses.replace(registry.reduced("tinyllama-1.1b"), n_layers=1)
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", s, 1, "train"),
                         ((1, 1), ("data", "model")), cfg=cfg)
    assert "error" not in rec and rec["flops"] > 0
    assert rec["devices"] == 1 and rec["collective_bytes"] == {}


def test_decode_cell_gathers_no_weight_whole():
    cfg = registry.reduced("tinyllama-1.1b")
    rec = dryrun.lm_cell("tinyllama-1.1b", ShapeSpec("x", 128, 4, "decode"),
                         ((2, 2), ("data", "model")), cfg=cfg)
    leaves = tree_leaves(api.abstract_params(cfg))
    whole = sum(t.numel() * t.element_size() for t in leaves)
    # the largest leaf a layer uses whole: the embedding (layer leaves
    # are stacked over the layers and used one layer at a time)
    largest = max(math.prod(t.shape[1:] if t.dim() > 2 else t.shape)
                  * t.element_size() for t in leaves)
    assert rec["collective_bytes"]["all-gather"] < whole
    assert rec["collective_max_bytes"]["all-gather"] <= largest // 2
