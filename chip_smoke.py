"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main paths, and checks every result:

- at the full width of the JAX package's bench workload (VGA RGB-D, 89
  templates x 2 modalities, ``t_at_level=(5, 8)``, top_k 128):
  single-class template matching (``detect_frame_core`` through
  ``Detector``) and the fused detect -> refine -> verify frame
  (``detect_refine_core``, with bench.py's refine stage: 8 candidates x
  512-point clouds, 16 ICP iterations, the colored term, 512-point
  verification);
- at the full width of the JAX package's synthetic benchmark
  (``SYNTH_r05.json``: 9 classes x 810 templates in one bank, 320 x 240
  RGB-D, ``t_at_level=(4, 8)``, top_k 128, 96 hypotheses per class, 4
  seeds, 20 ICP iterations, drawn by ``synthetic.multiclass_workload``):
  the multi-class match (``MultiClassMatcher``, whose coarse level, at
  2.7e10 multiply-adds, takes the feature-list coarse scorer) and the
  fused multi-class frame (``FusedMultiClassPipeline``: 3456 ICP
  candidates);
- at the full width of the JAX package's multi-scale sweep
  (``tools/bench_multiscale_multiclass.py``: 15 classes x 337 templates in
  one bank, VGA RGB-D, ``t_at_level=(5, 8)``, top_k 128, 5 depth proposals,
  train depth 600 mm, drawn by ``synthetic.multiscale_workload``):
  multi-scale matching of every class in one pass (``MultiScaleMultiClass``)
  and of one class at a time (``MultiScaleDetector``);
- at the full width of the JAX package's synthetic accuracy benchmark
  (``SYNTH_r05.json``: the nine procedural meshes, 80-view spheres, 320 x
  240, top_k 128, 96 hypotheses per class, 4 seeds with the flip,
  verify_tau 6, 20 scenes): rendering, render-trained banks
  (``render_train_templates`` through ``benchmark.train_benchmark_bank``),
  and ``run_benchmark`` serving every scene through
  ``PoseEstimationService`` and scoring it with ADI and VSD;
- at the full width of the JAX package's LCHF tool (``tools/lchf_pipeline.py``
  pose_eval: the box, 320 x 240, f = 280, radius 500, 50-px patches at
  stride 10, 5 trees; 20 training views of its 420, 12 held-out views):
  training patches, the similarity matrix and the forest on the card, and
  ``evaluate_pose_recall`` with the forest walk on the card;
- at the full width of a bin-picking frame for the JAX package's
  segmentation path (``seg``: VGA RGB-D, f = 545, ``DaspConfig`` and
  ``pose_estimation`` defaults; ``synthetic.bin_picking_scene``: the nine
  meshes 450-600 mm away over a tilted floor): ``convex_cloud_seg`` and
  each object's ``pose_estimation``;
- at the full width of the bench workload, of one class of the
  multi-scale sweep, and of the multi-class and multi-scale workloads,
  over several ranks: the ``parallel`` entry points (``sharded_detect``,
  ``tiled_detect``, ``sharded_multiscale_detect``, and over ``data``
  ``sharded_detect_refine``, ``fused_multiclass_over_data`` and
  ``multiscale_multiclass_over_data``) on ranks that share the one card;
- the SIXD tool twins (``sixdpose_tpu_torch/tools``) at the mini-SIXD size
  of the JAX package's tool test (240 x 180, one object, two test views),
  the T-LESS ``check_poses_tless`` twin on a mini T-LESS tree of the same
  views, and the measurement twins at the JAX tools' defaults;
- bench.py's twin, ``python -m sixdpose_tpu_torch.bench``, at bench.py's
  workload (the bench workload above), as a user runs it;
- the dense-kernel route at the bench workload's full width and the twin
  of the JAX package's entry program (``sixdpose_tpu_torch.entry``, VGA, 16
  templates).

One JSON line per phase; a failing phase raises, so the script exits
non-zero:

1. env: versions, device, ``nvidia-smi`` name and power limit;
2. build: compiles every kernel in ``sixdpose_tpu_torch/csrc`` with nvcc;
3. match_vga: a few frames through ``Detector.match`` / ``match_arrays``
   at threshold 75 and at one low enough that most of the 128 candidates
   reach the refine kernel, and a batch of 4 through
   ``match_batch_arrays``, with the kernels' launch counts set to 0 just
   before and read just after; the GPU results must equal the port's CPU
   results (plain versions) and the batch the single-frame calls;
4. match_mc: ``MultiClassMatcher`` on the multi-class workload at 55 and
   at 30 (every class fills its 128 candidates: a pool of 1152 in one
   refine launch), launch counts set to 0 just before and read just after;
   one coarse-kernel launch per frame; equal to the CPU run;
5. match_ms: ``MultiScaleMultiClass`` on the multi-scale workload at 70 and
   at 30 (every class fills its 128 candidates: a scaled pool of 1920 in
   one refine launch), and ``MultiScaleDetector`` on every class, launch
   counts set to 0 just before and read just after (one coarse-kernel
   launch a frame); equal to the CPU run,
   each class's row equals ``MultiScaleDetector``'s, at least 3 valid
   proposals and one empty, and one frame under
   ``set_sync_debug_mode("error")``;
6. kernel_parity: the local-refine kernel against its plain version on the
   card, exactly, at the shapes of tests/test_pallas.py, at F = 700, at the
   levelup maximum F = 8191 and at F = 9000 (two table passes), and at the
   inputs the main paths gave it (bench B=1 and B=4, the multi-class pool,
   the scaled multi-scale pool);
7. coarse_parity: the coarse scorer on the card (the coarse-scorer
   kernel) against its plain version on the CPU and against the dense conv
   of kernels built from the same features, at the full-width bank (scale
   1, and four scales one of them 0), and at the LINEMOD-scale VGA call
   (15 x 337 templates; against the conv on the card only);
7b. coarse_score: the coarse-scorer kernel (``csrc/coarse_score.cu``) at
   the T-LESS and LINEMOD benchmark deployments' coarse calls
   (``synthetic.coarse_scorer_call``): equal to its plain gather-sum on the
   card, raw and counts; its time replayed from CUDA graphs and launched
   from Python, beside the bound, the plain version's time and that of the
   dense conv it stands in for (``time_dense_conv``); and the crossover
   sweep (``time_crossover``): the kernel against the dense conv at the
   bench bank's 89 templates and at 300 and 1,152;
7c. icp: the ICP kernel (``csrc/icp.cu``) at the fused T-LESS frame's
   call (240 candidates x 512 points, colour) and the LINEMOD host route's
   (57 x 1,024, colour on and off, and 57 x 4,100 with colour;
   ``synthetic.icp_call``): T, fitness and rmse equal to the bit to
   ``icp_batch_plain`` on the card; its time replayed from CUDA graphs and
   launched from Python, the kernels and the host microseconds of one
   ``icp_batch`` call, beside the bound and the plain version's time (no
   single PyTorch call computes ICP);
8. match_golden: the JAX golden of ``tools/torch_port_golden.py`` on the
   planted-object VGA scene;
9. refine_vga: ``detect_refine_core`` on the bench workload at thresholds
   75 (as bench.py) and 30 (8 live candidates refine), with the kernels'
   launch counts set to 0 just before and read just after, and one more
   frame under ``torch.cuda.set_sync_debug_mode("error")`` (nothing may
   wait for the device); the GPU results must equal the port's CPU results
   within the tolerances of ``FUSED_TOL``;
10. render: the nine meshes at 320 x 240, a batch of 16 poses each through
   ``render_depth_batch`` and the training renderer, and ``render`` in all
   three modes, the card against the port's CPU run (bitwise), the JAX
   golden's renders of ``tools/torch_port_synth_golden.py`` on the card
   (bitwise), a batch under ``set_sync_debug_mode("error")``, ms per batch;
11. train_synth: the full-width bank trained on the card (templates per
   class, training seconds), and the textured box at 60 views trained on
   the card and on the CPU: equal templates and infos; the full-width bank
   saved by ``TemplateBank.save_checkpoint`` and restored by
   ``load_checkpoint`` (its padded arrays equal the trained bank's to the
   bit, its infos exactly; save and restore seconds, bytes on disk), and
   the restored bank is the one ``synth`` serves;
12. refine_mc: as refine_vga, for ``FusedMultiClassPipeline`` on the multi-class
   workload at 55 and 30 (96 active hypotheses per class), one coarse-kernel
   launch a frame; its CPU run (about
   20 s a frame) goes on in a spawned worker beside the golden phases that
   follow (13 and 14), which report no time, and the phase's line follows
   ``synth_golden``'s;
13. refine_golden, mc_golden and ms_golden: ``FusedPipeline``, the
   multi-class match and ``FusedMultiClassPipeline`` on the card against the JAX
   goldens of the planted scenes, each planted object's top pose moving it
   by its planted shift; both multi-scale matchers against the JAX golden
   of the rescaled planted object, found at its planted scale and place;
14. synth_golden: ``run_benchmark`` and the service on the card at the
   golden's cut size over its JAX-trained bank: JAX's targets, hits, VSD
   hits and per-object recall, and the service's estimates (fused, host and
   multi-scale paths) within ``FUSED_TOL`` of JAX's, launch counts set to 0
   just before and read just after;
15. synth: ``run_benchmark`` at the ``SYNTH_r05.json`` settings over the
   full-width bank restored from its checkpoint, launch counts set to 0 just before and read just after;
   one line ``{"synth": {...}}`` with the recall, the VSD recall, targets,
   hits, per-object recall, training seconds and per-frame times beside the
   record, gated at 77 +- 2 targets and each recall no lower than the
   record's minus 0.10;
16. lchf: the ``phase="exact"`` orientation bins of every integer Sobel pair
   on the card against the CPU; training patches (the first 200 or more
   against the CPU), the similarity matrix (against the CPU), the forest
   trained from the card's matrix (against the one trained from the CPU's,
   node for node); ``evaluate_pose_recall`` over the 12 held-out views with
   the refine kernel's launch count set to 0 just before and read just
   after (the path reaches no kernel); on 3 views ROIs, leaves, the vote
   tensor, top bins and hypotheses equal to the CPU's and refined poses
   within ``FUSED_TOL``; stage times (extraction per patch, the matrix
   beside its bytes bound, host training, the walk per scene, the votes,
   ICP per view) and launch counts; then the JAX golden of
   ``tools/torch_port_lchf_golden.py`` at 160 x 120.  One line
   ``{"lchf": {...}}``;
17. seg: the bin-picking frame through ``convex_cloud_seg`` and one
   ``pose_estimation`` per object (the segment covering most of its visible
   mask, in mm, against 2048 points of its mesh's surface), the kernels'
   launch counts set to 0 just before and read just after (the refine
   kernel's must stay 0); the pixel maps, seeds, ALIC indices and means,
   segments and every T and lcp equal to the port's CPU run (a spawned
   worker) to the bit; the segment-sum and seeding kernels against their
   plain versions (and the segment-sum layout against ``csr_layout``) at
   the frame's inputs and at edge cases (the longest chain, every id out
   of range, S past 1,024; dense seeds, values exactly one half, the widest
   width); the segment sums timed whole, as layout and as sums, beside
   ``index_add_``; the seeding scan beside the chain probe (the scan's
   per-pixel chain alone in one thread, its measured bound); stage times
   (pixel stage, seeds, ALIC by CUDA events; grouping and each registration
   by the host clock), device-to-host reads per frame, segments, accepted
   registrations and their ADI errors against the ground truth (reported,
   not gated).  One line ``{"seg": {...}}``; then seg_golden: the card
   against the JAX golden of ``tools/torch_port_seg_golden.py`` at
   320 x 240;
18. parallel: the ``parallel`` entry points on the bench batch and one
   multi-scale class: mesh (1, 1, 1) over NCCL equal to
   ``Detector.match_batch_arrays``; data 2 x template 2, tile 2,
   template-2 multi-scale and data 2 x template 2 detection with ICP of
   every candidate (``detect_icp``) on four ranks sharing the card over
   gloo, each equal to four CPU ranks, and data 2 x template 2 again with
   each rank's template shard restored from the bank's checkpoint
   (``restore_local_levels``): every rank's shard equal to the ``levels``
   route's and its outputs equal to that job's, to the bit, one refine
   launch a level, its restore seconds and bytes read; the dense-kernel
   route (the bench bank without feature lists) at data 2 x template 2 and
   tile 2, equal to four CPU ranks and to the same mesh computed in one
   process on the card, every slot, with no refine launch; in a second spawn, the fused
   multi-class frame (``fused_mc``, the multi-class workload) and the
   multi-scale multi-class frame (``fused_ms``, the multi-scale workload)
   at data 4 on four frames, each rank's frames equal to the
   single-process card pipeline to the bit; refine launches per rank;
   rank 0's ms per step and per merge collective (CUDA events) and its
   device ms per step (torch.profiler); each rank's peak device memory;
19. tools: the tool twins' compute (train, detect, ADI errors, recall) on
   the card against the same chain on the CPU, ``vis_poses``'
   overlays of the ground truth and of the estimates, the card's equal to
   the CPU's byte for byte, and the measurement twins at their defaults:
   ``bench_stage_breakdown`` (ms per prefix and per stage of the bench
   frame) and ``bench_local_refine`` (``equivalent: true``, then the
   kernel's, the plain version's and the grouped conv's ms and the bound);
   ``check_poses_tless`` through its ``main`` on a mini T-LESS tree of the
   two views, renders on the card and on the CPU: the same PNGs, byte for
   byte;
19b. bench: ``python -m sixdpose_tpu_torch.bench`` in a process of its own
   with ``SIXDPOSE_BENCH_BUDGET_S`` at ``BENCH_BUDGET_S``: bench.py's
   cumulative record (``value`` = match fps, ``vs_baseline``,
   ``detect_refine_fps``, ``detect_refine_vs_baseline``,
   ``match_fps_b{2,4,8}``, every one above 0, the card's name and power
   limit, the refine kernel's launches in that run), re-emitted on the
   ``bench`` line; then the gate bench.py lacks on the synthetic bank, at
   thresholds 75 and 30: the twin's one-frame chain and one step of its
   batch chain at B = 2, 4 and 8 (bench.py's batch frames), on the card
   against the port's CPU on the same frames, to the bit;
19c. dense_route: the dense-kernel route (a bank without feature lists,
   refined by the grouped conv of ``similarity_local``, as the JAX package
   refines such a bank), with the refine kernel's launch count set to 0
   just before and read just after (it must stay 0): ``entry()``, the twin
   of ``__graft_entry__.entry()``, on the card equal to the CPU and to the
   JAX golden of ``tools/torch_port_entry_golden.py``; the bench workload
   without its lists at 75 and 30, B = 1 and 4, equal to the CPU in every
   slot, to the bit, and beside it whether its live slots equal the sparse
   route's; ms per frame of both routes, ms per grouped conv a level, and
   peak device memory per frame;
20. timing: CUDA-event medians of ``detect_frame_core`` per frame at B=1 and
   B=4, and of ``detect_refine_core`` per frame at B=1 (thresholds 75 and
   30) split by stage with CUDA events between stages, beside per-frame
   bounds of the scene maps and of ICP; and of the kernel (replayed from
   CUDA graphs, so host launch overhead is left out, and launched from
   Python) and its plain version, beside the bound, at three calls: the
   main path's B=1 level-0 call, its B=4 call and a K=1020, F=136 pool,
   with the rate at which the kernel moves the L2 sectors its gather
   requests; at the B=1 call also one PyTorch library call computing the
   same function.  Under ``multiclass``: the multi-class match frame and
   the fused multi-class frame (whole and by stage, with bounds), the
   kernel at the multi-class call (and one grouped conv there), and the
   coarse scorer at full width and at the LINEMOD-scale call beside its
   bound and the dense conv.
   Under ``multiscale``: the one-pass frame and the single-class frame,
   whole and by stage (pyramid, proposals, coarse sweep, selection, refine,
   sort and NMS), the coarse sweep beside its bound and the dense conv of
   scaled kernels, and the kernel at the K=1920 scaled call
   beside its bound, its plain version and one grouped conv.
   Under ``synth``: the service's stage times per served frame, device ms
   per fused frame, render ms per 16-view batch and training seconds per
   class;
21. profile, profile_refine, profile_mc, profile_ms, profile_synth:
   torch.profiler's split of a B=1 match frame, of a B=1 detect+refine frame, of a fused
   multi-class frame, of a one-pass multi-scale frame and of one frame
   served by ``PoseEstimationService`` on a rendered benchmark scene into
   device kernels and host ops, and the device's idle share;
22. kernels: one line ``{"kernels": [...]}`` with, per kernel, its route,
   source, the TPU kernels it replaces (the seg kernels replace none: the
   JAX code they take the place of), its launches in the main paths'
   phases (in all and per phase, ``synth_golden``, ``synth``, ``lchf``,
   ``seg``, ``parallel`` (summed over every card rank), ``tools`` and
   ``bench`` (the twin's process) among them; the coarse kernel's counted
   in this process alone, with every launch checked against a feature-list
   coarse call and ``dense_route``'s required to be 0, the timing loops
   left out), its error against the plain version, and its time
   beside the plain version's, the library call's and the bound (the
   refine kernel at the bench B=1 call, the multi-class call and the
   multi-scale call; the seg kernels at the bin-picking frame's inputs,
   with the segment sums' ``split_ms`` and the scan's measured
   ``chain_bound_ms``), and each kernel's ``ptxas`` (registers, shared
   memory, spills); then the ``nvidia-smi`` line again.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script prints no result and exits 2.  ``python3 chip_smoke.py
parallel`` runs env, build and the ``parallel`` phase only, then, with two
or more cards, ``tools.bench_scaling``'s sweep over them (one line
``scaling``): on a host with four cards every rank has a card of its own
and the ranks talk over NCCL.  ``python3 chip_smoke.py coarse_score`` runs
env, build and the ``coarse_score`` phase only; ``python3 chip_smoke.py
icp`` env, build and the ``icp`` phase.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from sixdpose_tpu_torch import bench as TBN
from sixdpose_tpu_torch import benchmark as TB
from sixdpose_tpu_torch import serving as SV
from sixdpose_tpu_torch import synthetic
from sixdpose_tpu_torch.config import DetectorConfig, IcpConfig
from sixdpose_tpu_torch.convert import bank_levels_from_numpy, without_features
from sixdpose_tpu_torch.entry import entry as port_entry
from sixdpose_tpu_torch.eval import pose_error
from sixdpose_tpu_torch.eval.misc import model_diameter
from sixdpose_tpu_torch.geometry import render as GR
from sixdpose_tpu_torch.geometry.transform import random_rotation
from sixdpose_tpu_torch.geometry.view_sampler import sample_views
from sixdpose_tpu_torch.lchf import (
    Forest,
    LchfConfig,
    LchfModel,
    Node,
    PatchFeature,
    PatchSet,
    accumulate_votes,
    decode_bin_poses,
    evaluate_pose_recall,
    extract_patch_feature,
    make_training_patches,
    refine_lchf_poses,
    scene_roi_set,
    train_forest,
)
from sixdpose_tpu_torch.lchf.device import DeviceForest, DeviceRoiSet, similarity_matrix_device
from sixdpose_tpu_torch.lchf.pose import lchf_vote_bins
from sixdpose_tpu_torch.lchf.voting import dense_rois
from sixdpose_tpu_torch.models import detector as D
from sixdpose_tpu_torch.models import multiscale as M
from sixdpose_tpu_torch.models import pipeline as P
from sixdpose_tpu_torch.models import refine as TR
from sixdpose_tpu_torch.models import train as TT
from sixdpose_tpu_torch.models.detector import Detector, detect_frame_core
from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher
from sixdpose_tpu_torch.models.multiscale import MultiScaleDetector, MultiScaleMultiClass
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline, FusedPipeline
from sixdpose_tpu_torch.models.templates import TemplateBank
from sixdpose_tpu_torch.ops import _build
from sixdpose_tpu_torch.ops import coarse_score as CS
from sixdpose_tpu_torch.ops import floyd_steinberg as FSK
from sixdpose_tpu_torch.ops import icp as OI
from sixdpose_tpu_torch.ops import local_refine as LR
from sixdpose_tpu_torch.ops import quantize as Q
from sixdpose_tpu_torch.ops import segment_sum as SS
from sixdpose_tpu_torch.ops.scale_proposal import propose_depth_bins
from sixdpose_tpu_torch.ops.similarity import (
    _feature_table,
    _local_conv_operands,
    _s2d_kernels,
    build_kernels_scaled,
    similarity_dense,
    similarity_dense_pre_s2d,
    similarity_local,
    similarity_local_sparse,
    similarity_multiscale_auto,
    similarity_multiscale_sparse,
)
from sixdpose_tpu_torch.seg import DaspConfig as SegConfig
from sixdpose_tpu_torch.seg import convex_cloud_seg as seg_convex_cloud_seg
from sixdpose_tpu_torch.seg import frame_tensors as seg_frame_tensors
from sixdpose_tpu_torch.seg import pose_estimation as seg_pose_estimation
from sixdpose_tpu_torch.seg import superpixel_stage
from sixdpose_tpu_torch.seg.dasp import alic_iterate as seg_alic
from sixdpose_tpu_torch.seg.dasp import alic_pixel_table as seg_alic_pixel_table
from sixdpose_tpu_torch.seg.dasp import convex_grouping as seg_convex_grouping
from sixdpose_tpu_torch.seg.dasp import floyd_steinberg_seeds as seg_seeds
from sixdpose_tpu_torch.seg.dasp import pixel_stage as seg_pixel_stage
from sixdpose_tpu_torch.parallel import fused as PF
from sixdpose_tpu_torch.parallel.distributed import backend_for, run_ranks
from sixdpose_tpu_torch.parallel.rank_jobs import run_jobs
from sixdpose_tpu_torch.parallel.sharded_match import merge_topk, multiscale_class_arrays, shard_bank
from sixdpose_tpu_torch.parallel.tiled_match import required_halo
from sixdpose_tpu_torch.ops.topk_nms import nms_boxes
from sixdpose_tpu_torch.serving import PoseEstimationService
from sixdpose_tpu_torch.tools import detect_sixd as tools_detect
from sixdpose_tpu_torch.tools import eval_calc_errors as tools_errors
from sixdpose_tpu_torch.tools import bench_local_refine as tools_refine
from sixdpose_tpu_torch.tools import bench_scaling as tools_scaling
from sixdpose_tpu_torch.tools import bench_stage_breakdown as tools_stages
from sixdpose_tpu_torch.tools import eval_loc as tools_loc
from sixdpose_tpu_torch.tools import train_templates as tools_train
from sixdpose_tpu_torch.tools import check_poses_tless as tools_tless
from sixdpose_tpu_torch.tools import vis_poses as tools_vis

ROOT = os.path.dirname(os.path.abspath(__file__))
nvidia_smi = TBN.nvidia_smi
TESTDATA = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata")
BENCH_CFG = DetectorConfig(t_at_level=(5, 8))
LOW_THRESHOLD = 30.0
MIN_LIVE = 64
FUSED = ("tid", "x", "y", "score", "R", "t_mm", "fitness", "verify", "active")
# GPU against CPU (and against the JAX golden) for the fused frame: tid, x,
# y, score and active exactly; R per entry and t in mm absolutely; fitness
# and verify within 2 points of their N cloud / P verify points.
FUSED_TOL = {"R": 1e-4, "t_mm": 0.1, "fitness_points": 2, "verify_points": 2}
STAGES = ("match", "seed_and_fan", "scene_maps", "icp", "compose_and_verify")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core rate; the kernel's int32 adds run there
REPLACES = [
    "sixdpose_tpu/ops/pallas/local_refine.py:772 similarity_local_sparse_pallas (v1, _refine_kernel :51)",
    "sixdpose_tpu/ops/pallas/local_refine.py:162 similarity_local_sparse_pallas_v2 (_refine_kernel_v2 :108)",
    "sixdpose_tpu/ops/pallas/local_refine.py:308 similarity_local_sparse_pallas_v3 (_refine_kernel_v3 :251)",
    "sixdpose_tpu/ops/pallas/local_refine.py:472 similarity_local_sparse_pallas_v4 (_refine_kernel_v4 :400)",
    "sixdpose_tpu/ops/pallas/local_refine.py:646 similarity_local_sparse_pallas_v5 (_refine_kernel_v5 :578)",
]


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_summary(log: str) -> list:
    """Per kernel function in ``nvcc -Xptxas -v``'s log: registers, static
    shared memory, stack frame and spill bytes (names demangled where
    ``c++filt`` is on the PATH)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_static_bytes"] = int(sm.group(1)) if sm else 0
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f["function"] for f in out), capture_output=True,
                               text=True).stdout.splitlines()
        for f, name in zip(out, names):
            f["function"] = name
    return out


def sm_clock_mhz() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


# Coarse-kernel launches of each phase that drives a feature-list coarse
# path (``counting_coarse_calls``); the kernels line reports their sum.
COARSE_BY_PHASE: dict = {}


@contextmanager
def counting_coarse_calls(phase: str):
    """Set the coarse kernel's launch count to 0, record every feature-list
    coarse call the main path makes on card tensors (at the dispatch of
    ``coarse_scores`` and ``coarse_sweep``), and on leaving check one
    launch per such call and keep the count under ``phase`` in
    ``COARSE_BY_PHASE``.  Yields the list of calls ((maps shape, rows))."""
    calls: list = []
    original = similarity_multiscale_auto

    def counting(maps, feats, valid, scales, *rest):
        if maps.is_cuda and feats.shape[0] * scales.numel() > 0:
            calls.append((tuple(maps.shape), feats.shape[0] * scales.numel()))
        return original(maps, feats, valid, scales, *rest)

    CS.similarity_multiscale_cuda.launches = 0
    D.similarity_multiscale_auto = M.similarity_multiscale_auto = counting
    try:
        yield calls
    finally:
        D.similarity_multiscale_auto = M.similarity_multiscale_auto = original
    launches = CS.similarity_multiscale_cuda.launches
    check(launches == len(calls), f"{phase}: {launches} coarse-kernel launches for {len(calls)} feature-list coarse calls")
    COARSE_BY_PHASE[phase] = launches


# ICP-kernel launches of each phase whose main path calls ``icp_batch``
# (``counting_icp_calls``); the kernels line reports their sum.
ICP_BY_PHASE: dict = {}
# The names ``icp_batch`` is looked up under (``lchf.pose`` imports it from
# ``models.refine`` at each call).
ICP_CALLERS = (TR, P, SV, PF)


@contextmanager
def counting_icp_calls(phase: str, least: int = 0):
    """Set the ICP kernel's launch count to 0, record every ``icp_batch``
    call with candidates that the main path makes on card tensors (at each
    name in ``ICP_CALLERS``), and on leaving check one launch per such call
    and at least ``least`` calls, and keep the count under ``phase`` in
    ``ICP_BY_PHASE``.  Yields the list of calls ((K, N) each)."""
    calls: list = []
    original = TR.icp_batch

    def counting(model_pts, *rest, **kw):
        if model_pts.is_cuda and model_pts.shape[0] > 0:
            calls.append(tuple(model_pts.shape[:2]))
        return original(model_pts, *rest, **kw)

    OI.icp_cuda.launches = 0
    for m in ICP_CALLERS:
        m.icp_batch = counting
    try:
        yield calls
    finally:
        for m in ICP_CALLERS:
            m.icp_batch = original
    launches = OI.icp_cuda.launches
    check(launches == len(calls), f"{phase}: {launches} ICP-kernel launches for {len(calls)} icp_batch calls")
    check(len(calls) >= least, f"{phase}: {len(calls)} icp_batch calls on the card, expected at least {least}")
    ICP_BY_PHASE[phase] = launches


@contextmanager
def recording_refine_calls(calls: list):
    """Record the inputs of every local-refine call the main path makes, at
    the detector's dispatch; the calls still go through the wrapper and its
    launch count."""
    original = D.similarity_local_sparse_auto

    def recorder(maps, feats, valid, origins, t, window=16, scale=None, active=None):
        calls.append(dict(maps=maps, feats=feats, valid=valid, origins=origins, t=t,
                          window=window, scale=scale, active=active))
        return original(maps, feats, valid, origins, t, window, scale, active)

    D.similarity_local_sparse_auto = recorder
    try:
        yield
    finally:
        D.similarity_local_sparse_auto = original


def same_live(a, b) -> bool:
    """(tid, x, y, score, keep) equal on live entries (score >= 0); keep and
    deadness equal everywhere."""
    a = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in a]
    b = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in b]
    live = a[3] >= 0
    if not (np.array_equal(b[3] >= 0, live) and np.array_equal(a[4], b[4])):
        return False
    return all(np.array_equal(x[live], y[live]) for x, y in zip(a[:4], b[:4]))


def bench_detectors(dev):
    cid, templates, rgb, dep = synthetic.bench_bank()
    dets = []
    for device in (dev, "cpu"):
        det = Detector(BENCH_CFG, device=device)
        for tl in templates:
            det.bank.add_template_levels(cid, tl)
        dets.append(det)
    frames = np.stack([rgb ^ np.uint8(i) for i in range(4)])  # bench.py's batch frames
    depths = np.stack([dep] * 4)
    return cid, dets[0], dets[1], frames, depths


def phase_match_vga(dev, cid, det, det_cpu, frames, depths):
    t0 = time.perf_counter()
    calls: list = []
    LR.similarity_local_sparse_cuda.launches = 0
    with recording_refine_calls(calls):
        matches = [det.match(frames[i], depths[i], 75.0) for i in range(2)]
        gpu_75 = [det.match_arrays(frames[i], depths[i], 75.0, cid) for i in range(2)]
        n_before_low = len(calls)
        gpu_low = [det.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid) for i in range(2)]
        batch = det.match_batch_arrays(frames, depths, LOW_THRESHOLD, cid)
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    live_in = [c["active"].sum(dim=-1).tolist() for c in calls]  # per call, per frame
    check(launches == len(calls) and launches > 0, f"refine launches {launches} for {len(calls)} calls")
    low_live = [n for per_frame in live_in[n_before_low:] for n in per_frame]
    check(min(low_live) >= MIN_LIVE, f"only {min(low_live)} live candidates reached the kernel at {LOW_THRESHOLD}")

    cpu_75 = [det_cpu.match_arrays(frames[i], depths[i], 75.0, cid) for i in range(2)]
    cpu_low = [det_cpu.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid) for i in range(2)]
    for g, c in zip(gpu_75 + gpu_low, cpu_75 + cpu_low):
        check(same_live(g, c), "GPU and CPU results differ on the bench workload")
    batch_eq = True
    for i in range(4):
        single = det.match_arrays(frames[i], depths[i], LOW_THRESHOLD, cid)
        batch_eq &= all(torch.equal(b[i], s) for b, s in zip(batch, single))
    check(batch_eq, "match_batch_arrays differs from single-frame calls")
    emit(
        "match_vga", t0, launches=launches, refine_calls=len(calls),
        live_into_kernel=live_in, thresholds=[75.0, LOW_THRESHOLD],
        live_out_75=[int((m[3] >= 0).sum()) for m in gpu_75],
        live_out_low=[int((m[3] >= 0).sum()) for m in gpu_low],
        matches_75=[len(m) for m in matches], gpu_equals_cpu=True, batch4_equals_single=True,
    )
    return calls, launches


def _random_case(rng, dev, c, h, w, t, k, f, with_scale, b=None, with_active=False):
    lead = (k,) if b is None else (b, k)
    maps = rng.integers(0, 5, ((c, h, w) if b is None else (b, c, h, w))).astype(np.uint8)
    feats = np.stack(
        [rng.integers(0, 120, lead + (f,)), rng.integers(0, 150, lead + (f,)), rng.integers(0, c, lead + (f,))], -1
    ).astype(np.int32)
    valid = rng.random(lead + (f,)) < 0.9
    org = (rng.integers(0, min(h, w) // t - 8, lead + (2,)) * t).astype(np.int32)
    case = dict(maps=maps, feats=feats, valid=valid, origins=org, t=t, window=16, scale=None, active=None)
    if with_scale:
        case["scale"] = rng.uniform(0.4, 1.3, lead).astype(np.float32)
    if with_active:
        case["active"] = rng.random(lead) < 0.7
    return {n: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v for n, v in case.items()}


def _run(fn, c):
    return fn(c["maps"], c["feats"], c["valid"], c["origins"], c["t"], c["window"], c["scale"], c["active"])


def phase_kernel_parity(dev, calls, mc_calls, ms_call):
    t0 = time.perf_counter()
    rng = np.random.default_rng(42)
    cases = {
        "vga_t5_K16_F64_scale": _random_case(rng, dev, 16, 480, 640, 5, 16, 64, True),
        "production_pool_K1020_F136_scale": _random_case(rng, dev, 16, 480, 640, 5, 1020, 136, True),
        "batch4_vga_t5_K16_F64_scale": _random_case(rng, dev, 16, 480, 640, 5, 16, 64, True, b=4),
    }
    wide = _random_case(rng, dev, 16, 480, 640, 4, 64, 120, False)  # s2d width 160, as v1 took
    wide["window"] = 11
    cases["vga_t4_K64_F120_window11"] = wide
    act = _random_case(rng, dev, 8, 128, 128, 4, 8, 16, False)
    act["valid"][:, 10:] = False  # padded tails
    act["active"] = torch.tensor([True, False] * 4, device=dev)
    cases["active_t4_K8_F16_tails"] = act
    cases["vga_t5_K5_F700_scale_active"] = _random_case(rng, dev, 16, 480, 640, 5, 5, 700, True, with_active=True)
    cases["levelup_max_K4_F8191_scale_active"] = _random_case(rng, dev, 16, 480, 640, 5, 4, 8191, True, with_active=True)
    cases["two_passes_K3_F9000_scale_active"] = _random_case(rng, dev, 16, 480, 640, 5, 3, 9000, True, with_active=True)
    cases["main_path_B1"] = next(c for c in calls if c["maps"].shape[0] == 1)
    cases["main_path_B4"] = next(c for c in calls if c["maps"].shape[0] == 4)
    cases["multiclass_pool_K1152"] = mc_calls[-1]  # the full-width multi-class call at LOW_THRESHOLD
    cases["multiscale_pool_K1920_scaled"] = ms_call  # the full-width multi-scale call at LOW_THRESHOLD
    results = {}
    max_err = 0.0
    for name, c in cases.items():
        ks, kc = _run(LR.similarity_local_sparse_cuda, c)
        ps, pc = _run(similarity_local_sparse, c)
        torch.cuda.synchronize()
        err = float((ks - ps).abs().max()) if ks.numel() else 0.0
        exact = torch.equal(ks, ps) and torch.equal(kc, pc)
        results[name] = {"shape": list(ks.shape), "exact": exact, "max_abs_err": err}
        max_err = max(max_err, err)
        check(exact, f"kernel differs from its plain version in case {name}")
    emit("kernel_parity", t0, tolerance="exact (sums of small integers in float32)", cases=results)
    return max_err, cases["production_pool_K1020_F136_scale"]


def phase_match_golden(dev):
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    cfg = DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"]))
    det = Detector.read_classes(os.path.join(TESTDATA, "planted_bank.npz"), cfg, device=dev)
    rgb, depth = synthetic.planted_scene(*(int(v) for v in g["scene_xy"]), seed=int(g["scene_seed"]))
    out = det.match_arrays(rgb, depth, float(g["threshold"]), "planted")
    golden = [g[k] for k in ("tid", "x", "y", "score", "keep")]
    check(same_live(golden, out), "GPU result differs from the JAX golden")
    tid, x, y, score, keep = (a.cpu().numpy() for a in out)
    top = int(np.flatnonzero(keep & (score >= 0))[0])
    check((int(tid[top]), int(x[top]), int(y[top])) == (0, *(int(v) for v in g["expected_xy"])),
          "top match is not the planted object")
    emit("match_golden", t0, equals_jax=True, top_match=[int(tid[top]), int(x[top]), int(y[top]), float(score[top])],
         planted=[int(v) for v in g["expected_xy"]], live=int((score >= 0).sum()))


def fused_diff(a, b, n_points: int, n_verify: int) -> dict:
    """Compare two fused results (``FUSED`` order): whether active, and tid,
    x, y and score on active slots, are equal; the largest differences of
    the floats on active slots; whether every output is bitwise equal; and
    whether all is within ``FUSED_TOL``."""
    a = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in a]
    b = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in b]
    act = a[8]
    exact = np.array_equal(act, b[8]) and all(np.array_equal(a[i][act], b[i][act]) for i in range(4))
    err = {name: float(np.abs(a[i][act] - b[i][act]).max(initial=0.0)) for i, name in
           ((4, "R"), (5, "t_mm"), (6, "fitness"), (7, "verify"))}
    within = exact and err["R"] <= FUSED_TOL["R"] and err["t_mm"] <= FUSED_TOL["t_mm"] and (
        err["fitness"] <= FUSED_TOL["fitness_points"] / n_points + 1e-6) and (
        err["verify"] <= FUSED_TOL["verify_points"] / n_verify + 1e-6)
    return {"ints_equal": bool(exact), "max_err": err, "bitwise": all(np.array_equal(x, y) for x, y in zip(a, b)),
            "within_tol": bool(within), "active": int(act.sum())}


def frame_tensors(frames, depths, device, i: int = 0):
    return torch.from_numpy(frames[i]).to(device), torch.from_numpy(depths[i].astype(np.int32)).to(device)


def phase_refine_vga(dev, cid, det, det_cpu, frames, depths):
    t0 = time.perf_counter()
    b = synthetic.bench_refine_bank(det.device_bank(cid).whs[0].cpu().numpy())
    rgb, dep = frame_tensors(frames, depths, dev)
    rgb_c, dep_c = frame_tensors(frames, depths, "cpu")
    thresholds = (75.0, LOW_THRESHOLD)
    run = {thr: TBN.refine_runner(dep, det.device_bank(cid), b, thr) for thr in thresholds}
    run_cpu = {thr: TBN.refine_runner(dep_c, det_cpu.device_bank(cid), b, thr) for thr in thresholds}
    LR.similarity_local_sparse_cuda.launches = 0
    gpu = {thr: run[thr](rgb) for thr in thresholds}
    torch.cuda.synchronize()
    # One frame in which any wait for the device raises: nothing between the
    # upload above and the readback below may synchronize.
    torch.cuda.set_sync_debug_mode("error")
    try:
        unsynced = run[LOW_THRESHOLD](rgb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    check(launches > 0, "the refine kernel was not launched in the detect+refine frames")
    n_pts, n_ver = b["fields"][0].shape[1], len(b["verify_pts"])
    diffs = {str(thr): fused_diff(gpu[thr], run_cpu[thr](rgb_c), n_pts, n_ver) for thr in thresholds}
    for thr, d in diffs.items():
        check(d["within_tol"], f"detect_refine_core on the GPU differs from the CPU at threshold {thr}: {d}")
    check(diffs[str(LOW_THRESHOLD)]["active"] == b["max_refine"], f"not {b['max_refine']} active candidates at {LOW_THRESHOLD}")
    rerun = fused_diff(unsynced, gpu[LOW_THRESHOLD], n_pts, n_ver)
    check(rerun["bitwise"], "a second GPU run of the same frame differs")
    emit("refine_vga", t0, launches=launches, thresholds=list(thresholds), gpu_vs_cpu=diffs, tolerance=FUSED_TOL,
         sync_free_frame=True, rerun_bitwise_equal=True,
         fitness_low=[round(float(v), 4) for v in gpu[LOW_THRESHOLD][6].cpu()],
         verify_low=[round(float(v), 4) for v in gpu[LOW_THRESHOLD][7].cpu()])
    return launches, b


def phase_refine_golden(dev):
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "planted_refine_golden.npz"))
    scene = np.load(os.path.join(TESTDATA, "planted_golden.npz"))
    det = Detector.read_classes(os.path.join(TESTDATA, "planted_bank.npz"), BENCH_CFG, device=dev)
    pipe = FusedPipeline(
        det, "planted", g["K"], icp=IcpConfig(max_iters=int(g["icp_max_iters"])), max_refine=int(g["max_refine"]),
        num_points=int(g["num_points"]), verify_pts=g["verify_pts"], verify_colors=g["verify_colors"],
        icp_seeds=int(g["icp_seeds"]), seed_flip=bool(g["seed_flip"]), device=dev,
    )
    rgb, depth = synthetic.planted_scene(*(int(v) for v in scene["scene_xy"]), seed=int(scene["scene_seed"]))
    out = [a.cpu().numpy() for a in pipe(rgb, depth, float(g["threshold"]))]
    d = fused_diff([g[k] for k in FUSED], out, int(g["num_points"]), len(g["verify_pts"]))
    check(d["within_tol"] and d["active"] >= 3, f"the fused pipeline differs from the JAX golden: {d}")
    c = det.bank.infos["planted"][0]["icp_points"].astype(np.float64).mean(0) * 1000.0
    moved = out[4][0].astype(np.float64) @ c + out[5][0] - c
    miss = float(np.linalg.norm(moved - g["planted_shift_mm"]))
    check(out[8][0] and out[0][0] == 0 and miss <= float(g["translation_tol_mm"]),
          f"the top pose moves the object by {moved.tolist()} mm, planted {g['planted_shift_mm'].tolist()}")
    emit("refine_golden", t0, vs_jax=d, top_moves_object_mm=moved.tolist(),
         planted_shift_mm=g["planted_shift_mm"].tolist(), miss_mm=miss)


# -- every class of a bank: the multi-class match and fused frame ------------


def flat_classes(out):
    """(C, R, ...) results of the fused multi-class frame as (C * R, ...)."""
    return [a.reshape(-1, *a.shape[2:]) for a in out]


def multiclass_setup(dev):
    """The synthetic benchmark's multi-class workload at full width
    (``synthetic.multiclass_workload``: 9 classes x 810 templates, 320 x
    240), its detector, its matcher on the card and on the CPU, and its
    fused pipeline on the card."""
    t0 = time.perf_counter()
    w = synthetic.multiclass_workload()
    det = synthetic.multiclass_detector(w, dev)
    mc = {d: MultiClassMatcher(det, device=d) for d in (dev, "cpu")}
    pipe = FusedMultiClassPipeline(det, w["K"], device=dev, **synthetic.multiclass_pipeline_args(w))
    return w, mc[dev], mc["cpu"], pipe, time.perf_counter() - t0


def phase_match_mc(dev, w, mc, mc_cpu, setup_s: float):
    """``MultiClassMatcher`` on the full-width workload at 55 and at
    LOW_THRESHOLD, where every class fills its top_k candidates; equal to
    the port's CPU run everywhere."""
    t0 = time.perf_counter()
    calls: list = []
    thresholds = (w["threshold"], LOW_THRESHOLD)
    LR.similarity_local_sparse_cuda.launches = 0
    with counting_coarse_calls("match_mc") as coarse_calls, recording_refine_calls(calls):
        gpu = {thr: mc.match_arrays(w["rgb"], w["depth"], thr) for thr in thresholds}
        matches = {thr: mc.match(w["rgb"], w["depth"], thr) for thr in thresholds}
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    check(launches == len(calls) == 2 * len(thresholds) and launches > 0, f"refine launches {launches} for {len(calls)} calls")
    check(len(coarse_calls) == 2 * len(thresholds), f"{len(coarse_calls)} feature-list coarse calls in "
          f"{2 * len(thresholds)} frames")
    cpu = {thr: mc_cpu.match_arrays(w["rgb"], w["depth"], thr) for thr in thresholds}
    for thr in thresholds:
        check(all(torch.equal(g.cpu(), c) for g, c in zip(gpu[thr], cpu[thr])),
              f"MultiClassMatcher on the GPU differs from the CPU at threshold {thr}")
    live = {str(thr): (gpu[thr][3] >= 0).sum(1).tolist() for thr in thresholds}
    check(min(live[str(LOW_THRESHOLD)]) == w["cfg"].top_k, f"not every class fills its candidates at {LOW_THRESHOLD}: {live}")
    emit("match_mc", t0, setup_seconds=round(setup_s, 3), classes=len(mc.class_ids), templates=int(mc.bank.nfeats[0].numel()),
         frame=list(w["rgb"].shape), launches=launches, coarse_launches=COARSE_BY_PHASE["match_mc"], live_into_kernel=[int(c["active"].sum()) for c in calls],
         kernel_call={"maps": list(calls[-1]["maps"].shape), "feats": list(calls[-1]["feats"].shape), "t": calls[-1]["t"]},
         thresholds=list(thresholds), live_per_class=live, matches={str(t): len(m) for t, m in matches.items()},
         gpu_equals_cpu=True)
    return calls, launches


def scorer_bound(maps, feats, nfeat, ho_wo: int, n_scales: int = 1) -> dict:
    """Least bytes and operations of one call of the coarse scorer on these
    inputs: the maps, feature lists, masks and scales read once, the raw
    scores and counts written once; one add per counted feature and
    placement (the sparse product this data needs)."""
    sn = nfeat.numel()
    nbytes = maps.numel() + feats.numel() * 4 + feats.shape[0] * feats.shape[1] + 4 * n_scales + sn * (ho_wo * 4 + 4)
    ops = int(nfeat.sum()) * ho_wo
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_dense_conv(maps, feats, valid, scales, t: int, kh: int, kw: int, raw, rows: int = 2048) -> float:
    """The dense conv the coarse-scorer kernel stands in for, on one call's
    inputs (C, H, W): ``similarity_dense_pre_s2d`` over one-hot kernels of
    the call's features at each scale above 0 (``build_kernels_scaled``,
    space to depth, built outside the timed calls), ``rows`` templates a
    conv so the float32 kernels fit; each conv checked against the kernel's
    ``raw`` rows.  Returns the summed medians of 3 CUDA-event-timed eager
    calls a conv."""
    n, total = feats.shape[0], 0.0
    for s, sc in enumerate(scales.tolist()):
        if sc <= 0:  # no proposal: the kernel writes zeros without reading the maps
            continue
        for i in range(0, n, rows):
            kern = _s2d_kernels(build_kernels_scaled(feats[i : i + rows], valid[i : i + rows], sc, kh, kw,
                                                     maps.shape[-3]), t)
            conv = lambda: similarity_dense_pre_s2d(maps, kern, t)  # noqa: E731
            want = raw[s * n + i : s * n + i + kern.shape[0]]
            check(torch.equal(conv(), want), f"the dense conv differs from the coarse kernel (scale {sc}, rows {i}-)")
            total += cuda_ms(conv, reps=3)
            del kern, want
    torch.cuda.empty_cache()
    return total


def time_scorer(maps, feats, valid, t: int, kh: int, kw: int) -> dict:
    """The coarse scorer at scale 1 on one call's inputs: the coarse-scorer
    kernel (CUDA events over whole eager calls) beside its bound and the
    dense conv it stands in for (``time_dense_conv``)."""
    one = torch.ones((1,), dtype=torch.float32, device=maps.device)
    scorer = lambda: similarity_multiscale_auto(maps, feats, valid, one, t, kh, kw)  # noqa: E731
    raw, nf = scorer()
    return {
        "maps": list(maps.shape), "templates": int(feats.shape[0]), "F": int(feats.shape[1]), "kernel": [kh, kw], "t": t,
        "scorer_ms": cuda_ms(scorer, reps=10),
        "library_ms": time_dense_conv(maps, feats, valid, one, t, kh, kw, raw),
        "bound": scorer_bound(maps, feats, nf, raw.shape[-2] * raw.shape[-1]),
    }


def time_crossover(dev) -> dict:
    """The coarse route's crossover on the card (``time_scorer``, kernel
    against dense conv) on the bench frame's level-1 maps: at the bench
    bank (89 templates) and at 300 and 1,152 templates, the bench bank's
    feature lists repeated."""
    cid, templates, rgb, dep = synthetic.bench_bank()
    det = Detector(BENCH_CFG, device=dev)
    for tl in templates:
        det.bank.add_template_levels(cid, tl)
    bank = det.device_bank(cid)
    maps = det.build_response_pyramid(rgb, dep)[-1]
    feats, valid = bank.feats[-1], bank.valids[-1]
    out = {}
    for n in (feats.shape[0], 300, 1152):
        rows = torch.arange(n, device=dev) % feats.shape[0]
        out[str(n)] = time_scorer(maps, feats[rows].contiguous(), valid[rows].contiguous(), BENCH_CFG.t_at_level[-1],
                                  *bank.kdims[-1])
    return out


def linemod_scale_case(dev, n: int = 15 * 337):
    """A LINEMOD-scale coarse call (15 classes x 337 templates, VGA,
    ``sixdpose_tpu/models/multiclass.py:80``): level-1 response maps of a
    VGA frame (the bench frame's), ``n`` templates of 32 features in a 46 x
    46 extent, t = 8."""
    cid, templates, rgb, dep = synthetic.bench_bank(num_templates=1)
    det = Detector(BENCH_CFG, device=dev)
    det.bank.add_template_levels(cid, templates[0])
    maps = det.build_response_pyramid(rgb, dep)[1]
    rng = np.random.default_rng(15)
    f, ext = 32, 46
    feats = np.stack([rng.integers(0, ext, (n, f)), rng.integers(0, ext, (n, f)), rng.integers(0, 16, (n, f))], -1)
    valid = rng.random((n, f)) < 0.95
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return maps, to(feats.astype(np.int32)), to(valid), 8, ext, ext


def phase_coarse_parity(dev, w, mc, mc_cpu):
    """The coarse scorer on the card (the coarse-scorer kernel) against its
    plain version on the CPU and against the dense conv of kernels built
    from the same features: at the full-width bank (scale 1, and four
    scales one of them 0), and at the LINEMOD-scale VGA call (card only).
    Returns both calls' inputs (maps, feats, valid, t, kh, kw)."""
    t0 = time.perf_counter()
    maps = mc.response_pyramid(w["rgb"], w["depth"])[-1]
    t_c = w["cfg"].t_at_level[-1]
    feats, valid = mc.bank.feats[-1], mc.bank.valids[-1]
    kh, kw = mc.bank.kdims[-1]
    kern = build_kernels_scaled(feats, valid, 1.0, kh, kw, maps.shape[0])
    results = {}
    for name, scales in (("full_width_scale1", [1.0]), ("full_width_4_scales", [0.8, 1.0, 0.0, 1.2])):
        sc = torch.tensor(scales, dtype=torch.float32)
        g = similarity_multiscale_auto(maps, feats, valid, sc.to(dev), t_c, kh, kw)
        c = similarity_multiscale_auto(maps.cpu(), mc_cpu.bank.feats[-1], mc_cpu.bank.valids[-1], sc, t_c, kh, kw)
        check(torch.equal(g[0].cpu(), c[0]) and torch.equal(g[1].cpu(), c[1]), f"coarse scorer GPU differs from CPU ({name})")
        n = feats.shape[0]
        i1 = scales.index(1.0) * n
        dense = similarity_dense(maps, kern, t_c)
        check(torch.equal(g[0][i1 : i1 + n], dense), f"coarse scorer differs from the dense conv at scale 1 ({name})")
        if 0.0 in scales:
            i0 = scales.index(0.0) * n
            check(not g[0][i0 : i0 + n].any() and not g[1][i0 : i0 + n].any(), "scale 0 scored something")
        results[name] = {"raw": list(g[0].shape), "gpu_equals_cpu": True, "scale1_equals_dense": True}
    del kern
    lm_case = linemod_scale_case(dev)
    lm_maps, lm_feats, lm_valid, _, ext, _ = lm_case
    lm = similarity_multiscale_auto(lm_maps, lm_feats, lm_valid, torch.ones(1, device=dev), 8, ext, ext)
    lm_kern = build_kernels_scaled(lm_feats, lm_valid, 1.0, ext, ext, lm_maps.shape[0])
    check(torch.equal(lm[0], similarity_dense(lm_maps, lm_kern, 8)), "LINEMOD-scale coarse scorer differs from the dense conv")
    results["linemod_15x337_vga_scale1"] = {"raw": list(lm[0].shape), "equals_dense": True}
    del lm_kern
    torch.cuda.synchronize()
    emit("coarse_parity", t0, tolerance="exact (integer sums in float32)", cases=results)
    return (maps, feats, valid, t_c, kh, kw), lm_case



def time_coarse(dev, deployment: str) -> dict:
    """The coarse-scorer kernel at a benchmark deployment's coarse call
    (``synthetic.coarse_scorer_call``): equal to the plain gather-sum on
    the card, raw and counts; then its time replayed from a CUDA graph (20
    calls a window) and launched from Python, beside the bound, the plain
    version's time (one call a window, replayed from a CUDA graph too) and
    that of the dense conv it stands in for (``time_dense_conv``)."""
    call = synthetic.coarse_scorer_call(deployment)
    args = [torch.from_numpy(a).to(dev) for a in call[:4]] + list(call[4:])
    kernel = lambda: CS.similarity_multiscale_cuda(*args)  # noqa: E731
    raw, nf = kernel()
    want = similarity_multiscale_sparse(*args)
    check(torch.equal(raw, want[0]) and torch.equal(nf, want[1]), f"coarse kernel differs from the plain gather-sum "
          f"({deployment})")
    del want
    p = raw.shape[-2] * raw.shape[-1]
    bound = scorer_bound(args[0], args[1], nf, p, n_scales=args[3].numel())
    kern_ms = graph_ms(kernel, reps=7, inner=20)
    out = {
        "maps": list(args[0].shape), "rows": int(raw.shape[0]), "F": int(args[1].shape[1]), "scales": args[3].tolist(),
        "kernel": list(call[5:]), "t": call[4], "placements": p, "lookups": int(nf.sum()) * p,
        "kernel_ms": kern_ms,
        "kernel_eager_ms": cuda_ms(kernel, reps=7, inner=20),
        "plain_ms": graph_ms(lambda: similarity_multiscale_sparse(*args), reps=3, inner=1),
        "library_ms": time_dense_conv(*args, raw),
        "bound": bound,
    }
    out["lookups_per_ns"] = out["lookups"] / (kern_ms * 1e6)
    out["times_bound"] = kern_ms / bound["bound_ms"]
    del raw, nf, args
    torch.cuda.empty_cache()
    return out


def phase_coarse_score(dev) -> dict:
    """The coarse-scorer kernel at the T-LESS and LINEMOD deployments'
    coarse calls (``time_coarse``), with its launches over the phase."""
    t0 = time.perf_counter()
    CS.similarity_multiscale_cuda.launches = 0
    cases = {name: time_coarse(dev, name) for name in ("tless", "linemod")}
    crossover = time_crossover(dev)
    torch.cuda.synchronize()
    emit("coarse_score", t0, nvidia_smi=nvidia_smi(), tolerance="exact (integer sums in float32)", cases=cases,
         crossover=crossover, launches=CS.similarity_multiscale_cuda.launches,
         method=("CUDA events, medians: kernel_ms 7 windows of 20 calls replayed from one CUDA graph (warm L2); "
                 "kernel_eager_ms the same 20 calls issued from Python; plain_ms 3 windows of one call replayed "
                 "from a CUDA graph; library_ms the dense conv (cuDNN, float32 one-hot kernels built outside the "
                 "timed calls, 2,048 templates a conv), 3 eager calls a conv, summed; crossover: scorer_ms 10 "
                 "eager calls, library_ms as above; bound: bytes once each over 3.35 TB/s against one add per "
                 "counted feature and placement at 67 TFLOP/s"))
    return cases


# float32 operations of the plain ICP step, a point and an iteration,
# counted from csrc/icp.cu: the association with a nearest tap (47) or four
# bilinear taps (132), the 42 normal-equation terms of a point (384) and
# the tree's 46 adds; with colour the chroma tap and dc/dp (47) and the
# colour terms (294).  The solve is a few hundred a candidate.
ICP_OPS = {"nearest": 47 + 384 + 46, "bilinear": 132 + 384 + 46, "color": 47 + 294, "final": 132 + 10, "solve": 700}


def icp_bound(k: int, n: int, h: int, w: int, color: bool, icp: IcpConfig) -> dict:
    """Least time of one ICP call on the card: the scene tables (packed
    maps and chroma), the clouds, validity, chroma and start poses read once
    and the poses, fitness and rmse written once over 3.35 TB/s, against
    ``ICP_OPS`` over the iterations at 67 TFLOP/s."""
    n_bi = max(0, min(icp.bilinear_iters, icp.max_iters))
    n_coarse = -(-n // max(1, n // max(icp.coarse_points, 8)))
    ops = k * ((icp.max_iters - n_bi) * n_coarse * ICP_OPS["nearest"] + n_bi * n * ICP_OPS["bilinear"]
               + (icp.max_iters - n_bi) * n_coarse * ICP_OPS["color"] * color + n_bi * n * ICP_OPS["color"] * color
               + n * ICP_OPS["final"] + icp.max_iters * ICP_OPS["solve"])
    nbytes = h * w * (7 + 6 * color) * 4 + k * n * (12 + 1 + 8 * color) + k * 64 + k * (64 + 8)
    out = {"bytes": nbytes, "flops": ops, "bytes_ms": nbytes / 3.35e12 * 1e3, "flops_ms": ops / 67e12 * 1e3}
    out["bound_ms"] = max(out["bytes_ms"], out["flops_ms"])
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["flops_ms"] else "float32 operations"
    return out


def time_icp(dev, deployment: str, color: bool = True, k: int = None, n: int = None) -> dict:
    """The ICP kernel at a benchmark deployment's ICP call
    (``synthetic.icp_call``, ``IcpConfig``'s settings): T, fitness and rmse
    equal to ``icp_batch_plain`` on the card to the bit; then its time
    replayed from a CUDA graph (20 calls a window) and launched from Python,
    the kernels one ``icp_batch`` call launches and the host microseconds
    it takes to enqueue them, beside the bound and the plain version's
    time and kernels.  ``k`` and ``n`` override the deployment's counts."""
    icp = IcpConfig()
    c = synthetic.icp_call(deployment, k=k, n=n, color=color)
    K = torch.from_numpy(c["K"]).to(dev)
    sp = TR.backproject(torch.from_numpy(c["depth"]).to(dev), K)
    args = [torch.from_numpy(c["pts"]).to(dev), torch.from_numpy(c["valid"]).to(dev), sp, TR.scene_normals(sp), K,
            torch.from_numpy(c["init_T"]).to(dev)]
    kw = {f: getattr(icp, f) for f in ("corr_dist", "max_iters", "coarse_gate_mult", "color_weight", "chroma_scale",
                                       "point_weight", "lm_damping", "bilinear_iters", "coarse_points")}
    kw.update(model_chroma=None, chroma_maps=None)
    if color:
        kw.update(model_chroma=torch.from_numpy(c["chroma"]).to(dev),
                  chroma_maps=TR.scene_chroma(torch.from_numpy(c["rgb"]).to(dev)))
    kernel = lambda: TR.icp_batch(*args, **kw)  # noqa: E731
    plain = lambda: TR.icp_batch_plain(*args, **kw)  # noqa: E731
    before = OI.icp_cuda.launches
    got = kernel()
    check(OI.icp_cuda.launches == before + 1, f"icp_batch launched the ICP kernel {OI.icp_cuda.launches - before} times")
    want = plain()
    for g, wt, what in zip(got, want, ("T", "fitness", "rmse")):
        check(torch.equal(g, wt), f"ICP kernel {what} differs from icp_batch_plain ({deployment}, colour {color})")
    k, n = c["pts"].shape[:2]
    h, w = c["depth"].shape
    bound = icp_bound(k, n, h, w, color, icp)
    kern_ms = graph_ms(kernel, reps=7, inner=20)
    fit = want[1].cpu().numpy()
    out = {
        "K": k, "N": n, "frame": [h, w], "color": color, "max_iters": icp.max_iters,
        "fitness_median": float(np.median(fit)), "never_6_inliers_or_empty": int((fit == 0).sum()),
        "kernel_ms": kern_ms,
        "kernel_eager_ms": cuda_ms(kernel, reps=7, inner=20),
        "plain_ms": graph_ms(plain, reps=3, inner=1),
        "library_ms": "none",
        "kernels_per_call": kernel_launches(kernel),
        "plain_kernels_per_call": kernel_launches(plain),
        "host_us_per_call": host_us(kernel, n=200),
        "plain_host_us_per_call": host_us(plain, n=3),
        "bound": bound,
    }
    out["times_bound"] = kern_ms / bound["bound_ms"]
    del got, want, args, kw
    torch.cuda.empty_cache()
    return out


def phase_icp(dev) -> dict:
    """The ICP kernel at the fused T-LESS frame's call and the LINEMOD host
    route's, with and without colour, and at the host route's with 4,100
    points a cloud (above a thread's registers: the kernel streams them)
    (``time_icp``).  Its launches (timing
    loops and profiles) are its own: the count starts from 0 and the
    kernels line leaves them out."""
    t0 = time.perf_counter()
    OI.icp_cuda.launches = 0
    cases = {"tless_fused": time_icp(dev, "tless"), "linemod_host": time_icp(dev, "linemod"),
             "linemod_host_geometry": time_icp(dev, "linemod", color=False),
             "linemod_host_n4100": time_icp(dev, "linemod", n=4100)}
    torch.cuda.synchronize()
    emit("icp", t0, nvidia_smi=nvidia_smi(), tolerance="exact (torch.equal to icp_batch_plain on the card)",
         cases=cases, launches=OI.icp_cuda.launches,
         method=("CUDA events, medians: kernel_ms 7 windows of 20 icp_batch calls replayed from one CUDA graph (the "
                 "tables' packing, a few kernels, included); kernel_eager_ms the same 20 calls issued from Python; "
                 "plain_ms 3 windows of one icp_batch_plain call replayed from a CUDA graph; kernels per call by "
                 "torch.profiler; host_us: enqueue time a call back to back; bound: bytes once each over 3.35 TB/s "
                 "against ICP_OPS at 67 TFLOP/s"))
    return cases


def refine_mc_cpu(thresholds) -> dict:
    """The fused multi-class frame on the CPU (a spawned worker: the
    workload drawn again from its seed, its pipeline built on the CPU) at
    each of ``thresholds``: {threshold: (outputs as numpy, seconds)}."""
    w = synthetic.multiclass_workload()
    pipe = FusedMultiClassPipeline(synthetic.multiclass_detector(w, "cpu"), w["K"], device="cpu",
                                   **synthetic.multiclass_pipeline_args(w))
    out = {}
    for thr in thresholds:
        t = time.perf_counter()
        res = pipe(w["rgb"], w["depth"], thr)
        out[thr] = ([a.numpy() for a in res], time.perf_counter() - t)
    return out


def phase_refine_mc(dev, w, pipe):
    """``FusedMultiClassPipeline`` on the full-width workload (9 classes x
    96 hypotheses x 4 seeds = 3456 ICP candidates) at 55 and at
    LOW_THRESHOLD, and one more frame under ``set_sync_debug_mode("error")``.
    The CPU run to hold them against takes about 20 s a frame, so it starts
    after the card's frames, in a spawned worker beside the phases that
    follow (golden checks, which report no time): returns what
    ``finish_refine_mc`` needs to check and emit the phase once the worker
    is done."""
    t0 = time.perf_counter()
    thresholds = (w["threshold"], LOW_THRESHOLD)
    rgb, dep = torch.from_numpy(w["rgb"]).to(dev), torch.from_numpy(w["depth"].astype(np.int32)).to(dev)
    LR.similarity_local_sparse_cuda.launches = 0
    with counting_coarse_calls("refine_mc") as coarse_calls:
        gpu = {thr: pipe(rgb, dep, thr) for thr in thresholds}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            unsynced = pipe(rgb, dep, LOW_THRESHOLD)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    check(launches == len(thresholds) + 1, f"{launches} refine kernel launches in {len(thresholds) + 1} frames")
    # A feature-list bank: one coarse-kernel call a frame.
    check(len(coarse_calls) == len(thresholds) + 1, f"{len(coarse_calls)} feature-list coarse calls in "
          f"{len(thresholds) + 1} frames")
    gpu_s = time.perf_counter() - t0
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    cpu_run = pool.submit(refine_mc_cpu, thresholds)
    return {"t0": t0, "gpu_s": gpu_s, "pool": pool, "cpu_run": cpu_run, "w": w, "pipe": pipe,
            "thresholds": thresholds, "gpu": gpu, "unsynced": unsynced, "launches": launches}


def finish_refine_mc(p: dict) -> int:
    """The card's fused multi-class frames of ``phase_refine_mc`` against
    the worker's CPU run, within ``FUSED_TOL``, a second card run of the
    same frame to the bit, then the phase's line.  Returns its launches."""
    try:
        cpu = p["cpu_run"].result(timeout=PARALLEL_TIMEOUT)
    finally:
        p["pool"].shutdown(cancel_futures=True)
    w, gpu, thresholds = p["w"], p["gpu"], p["thresholds"]
    n_pts, n_ver = w["num_points"], min(len(v) for v in w["verify_pts"].values())
    diffs = {str(thr): fused_diff(flat_classes(gpu[thr]), flat_classes(cpu[thr][0]), n_pts, n_ver)
             for thr in thresholds}
    for thr, d in diffs.items():
        check(d["within_tol"], f"detect_refine_multiclass_core on the GPU differs from the CPU at threshold {thr}: {d}")
    active = {str(thr): gpu[thr][8].sum(1).tolist() for thr in thresholds}
    check(min(active[str(LOW_THRESHOLD)]) == w["max_refine"], f"not {w['max_refine']} active per class: {active}")
    rerun = fused_diff(flat_classes(p["unsynced"]), flat_classes(gpu[LOW_THRESHOLD]), n_pts, n_ver)
    check(rerun["bitwise"], "a second GPU run of the same frame differs")
    c_n = len(p["pipe"].class_ids)
    emit("refine_mc", p["t0"], launches=p["launches"], coarse_launches=COARSE_BY_PHASE["refine_mc"], thresholds=list(thresholds),
         icp_candidates=c_n * w["max_refine"] * w["icp_seeds"], active_per_class=active, gpu_vs_cpu=diffs,
         tolerance=FUSED_TOL, sync_free_frame=True, rerun_bitwise_equal=True, gpu_seconds_3_frames=p["gpu_s"],
         cpu_seconds_per_frame=sum(t for _, t in cpu.values()) / len(thresholds),
         verify_low_class0=[round(float(v), 4) for v in gpu[LOW_THRESHOLD][7][0, :8].cpu()])
    return p["launches"]


def phase_mc_golden(dev):
    """The planted multi-class golden of ``tools/torch_port_mc_golden.py``
    on the card: the match (live entries equal) and the fused frame (within
    ``FUSED_TOL``, each planted class's top pose at its planted shift)."""
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "planted_mc_golden.npz"))
    cids = [str(c) for c in g["class_ids"]]
    cfg = DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"]))
    det = Detector.read_classes(os.path.join(TESTDATA, "planted_mc_bank.npz"), cfg, device=dev)
    rgb, depth = synthetic.planted_scene_multi([tuple(p) for p in g["placements"].tolist()], seed=int(g["scene_seed"]))
    out = MultiClassMatcher(det, cids, device=dev).match_arrays(rgb, depth, float(g["threshold"]))
    golden = [g[k] for k in ("tid", "x", "y", "score", "keep")]
    check(same_live(golden, out), "the multi-class match differs from the JAX golden")
    counts = g["verify_count"]
    pipe = FusedMultiClassPipeline(
        det, g["K"], class_ids=cids, icp=IcpConfig(max_iters=int(g["icp_max_iters"])), max_refine=int(g["max_refine"]),
        num_points=int(g["num_points"]), icp_seeds=int(g["icp_seeds"]), seed_flip=bool(g["seed_flip"]),
        verify_pts={c: g["verify_pts"][i, : counts[i]] for i, c in enumerate(cids)},
        verify_colors={c: g["verify_colors"][i, : counts[i]] for i, c in enumerate(cids)}, device=dev,
    )
    fused = [a.cpu().numpy() for a in pipe(rgb, depth, float(g["refine_threshold"]))]
    d = fused_diff(flat_classes([g[f"fused_{k}"] for k in FUSED]), flat_classes(fused), int(g["num_points"]), int(counts.min()))
    check(d["within_tol"] and d["active"] >= 3, f"the fused multi-class frame differs from the JAX golden: {d}")
    misses = {}
    for (ci, _, _), shift in zip(g["placements"], g["planted_shift_mm"]):
        top = int(np.flatnonzero(fused[8][ci])[0])
        c = det.bank.infos[cids[ci]][0]["icp_points"].astype(np.float64).mean(0) * 1000.0
        moved = fused[4][ci, top].astype(np.float64) @ c + fused[5][ci, top] - c
        misses[cids[ci]] = float(np.linalg.norm(moved - shift))
        check(fused[0][ci, top] == 0 and misses[cids[ci]] <= float(g["translation_tol_mm"]),
              f"class {cids[ci]}'s top pose moves its object by {moved.tolist()} mm, planted {shift.tolist()}")
    emit("mc_golden", t0, match_equals_jax=True, fused_vs_jax=d, miss_mm=misses)


# -- multi-scale matching: MultiScaleMultiClass and MultiScaleDetector -------

MS_OUT = ("tid", "x", "y", "score", "keep", "depth_mm", "scale")
MS_STAGES = ("pyramid", "proposals", "coarse_sweep", "selection", "refine", "sort_nms")


def multiscale_setup(dev, classes: int = synthetic.MS_CLASSES, views: int = synthetic.MS_VIEWS):
    """The JAX package's multi-scale sweep at full width
    (``synthetic.multiscale_workload``: 15 x 337 templates, VGA, 5
    proposals), its detector, and its matchers ``MultiScaleMultiClass`` and
    ``MultiScaleDetector``, each on the card and on the CPU."""
    t0 = time.perf_counter()
    w = synthetic.multiscale_workload(classes, views)
    det = synthetic.multiscale_detector(w, dev)
    kw = dict(num_scales=w["num_scales"])
    ms = {
        "card": MultiScaleMultiClass(det, w["train_depth"], device=dev, **kw),
        "cpu": MultiScaleMultiClass(det, w["train_depth"], device="cpu", **kw),
        "single": MultiScaleDetector(det, w["train_depth"], device=dev, **kw),
        "single_cpu": MultiScaleDetector(det, w["train_depth"], device="cpu", **kw),
    }
    torch.cuda.synchronize()
    return w, ms, time.perf_counter() - t0


def _all_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _best(out, ci=None) -> list:
    """(tid, x, y, score, depth_mm, scale) of the first kept live entry of a
    multi-scale result (of class row ``ci``), or None."""
    rows = [a.cpu() if ci is None else a[ci].cpu() for a in out]
    live = torch.nonzero(rows[4] & (rows[3] >= 0)).flatten()
    if not len(live):
        return None
    i = int(live[0])
    return [int(rows[0][i]), int(rows[1][i]), int(rows[2][i]), float(rows[3][i]), float(rows[5][i]), float(rows[6][i])]


def phase_match_ms(dev, w, ms, setup_s: float):
    """The full-width multi-scale workload on the card, with the kernels'
    launch counts set to 0 just before and read just after:
    ``MultiScaleMultiClass`` at 70 and LOW_THRESHOLD (equal to the CPU
    run), ``MultiScaleDetector`` on every class (each class's row of the one-pass result equals it; one
    class against its CPU run), and one frame under
    ``set_sync_debug_mode("error")``."""
    t0 = time.perf_counter()
    rgb, dep = w["rgb"], w["depth"]
    thresholds = (w["threshold"], LOW_THRESHOLD)
    mc, single = ms["card"], ms["single"]
    cids = mc.class_ids
    one = cids[len(cids) // 2]
    rgb_t, dep_t = torch.from_numpy(rgb).to(dev), torch.from_numpy(dep.astype(np.int32)).to(dev)
    calls: list = []
    LR.similarity_local_sparse_cuda.launches = 0
    with counting_coarse_calls("match_ms") as coarse_calls, recording_refine_calls(calls):
        gpu = {thr: mc.match_arrays(rgb, dep, thr) for thr in thresholds}
        per_class = {thr: {cid: single.match_arrays(rgb, dep, thr, cid) for cid in cids} for thr in thresholds}
        matches = {thr: mc.match(rgb, dep, thr) for thr in thresholds}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            unsynced = mc.match_arrays(rgb_t, dep_t, LOW_THRESHOLD)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    levels_below = len(w["cfg"].t_at_level) - 1
    frames = len(thresholds) + len(thresholds) * len(cids) + len(thresholds) + 1
    check(launches == len(calls) == frames * levels_below, f"{launches} refine launches, {len(calls)} calls, {frames} frames")
    # One coarse sweep a frame, every one on the coarse kernel.
    check(len(coarse_calls) == frames, f"{len(coarse_calls)} feature-list coarse calls in {frames} frames")
    check(all(c["scale"] is not None for c in calls), "a multi-scale refine call without scales")
    # The one-pass calls (K = classes x top_k) in order: match_arrays() at
    # each threshold, match() at each, the sync-free frame.
    pool = len(cids) * w["cfg"].top_k
    pool_calls = [c for c in calls if c["feats"].shape[0] == pool]
    pool_thr = [*thresholds, *thresholds, LOW_THRESHOLD]
    live_in = [int(c["active"].sum()) for c in pool_calls]
    low_pool = [c for c, thr in zip(pool_calls, pool_thr) if thr == LOW_THRESHOLD]
    check(len(pool_calls) == len(pool_thr) and all(int(c["active"].sum()) == pool for c in low_pool),
          f"not {pool} live candidates in each one-pass refine call at {LOW_THRESHOLD}: {live_in}")

    check(_all_equal(unsynced, gpu[LOW_THRESHOLD]), "a second card run of the same frame differs")
    rows_equal, best = {}, {}
    for thr in thresholds:
        rows_equal[str(thr)] = all(_all_equal([a[ci] for a in gpu[thr]], per_class[thr][cid]) for ci, cid in enumerate(cids))
        check(rows_equal[str(thr)], f"a class's row differs from MultiScaleDetector's at {thr}")
        best[str(thr)] = [_best(gpu[thr], ci) for ci in range(len(cids))]
        for ci, cid in enumerate(cids):
            check(best[str(thr)][ci] == _best(per_class[thr][cid]),
                  f"class {cid}'s best match differs from MultiScaleDetector's at {thr}")
    t1 = time.perf_counter()
    cpu = {thr: ms["cpu"].match_arrays(rgb, dep, thr) for thr in thresholds}
    cpu_s = (time.perf_counter() - t1) / len(thresholds)
    for thr in thresholds:
        check(_all_equal(gpu[thr], cpu[thr]), f"MultiScaleMultiClass on the card differs from the CPU at {thr}")
        check(_all_equal(per_class[thr][one], ms["single_cpu"].match_arrays(rgb, dep, thr, one)),
              f"MultiScaleDetector on the card differs from the CPU at {thr}")
    bin_idx, depths, counts = propose_depth_bins(dep_t)
    n_valid = int((counts > 0).sum())
    check(n_valid >= 3 and n_valid < len(counts), f"{n_valid} valid proposals of {len(counts)}")
    live = {str(thr): (gpu[thr][3] >= 0).sum(1).tolist() for thr in thresholds}
    emit("match_ms", t0, setup_seconds=round(setup_s, 3), classes=len(cids), templates=int(mc.bank.feats[0].shape[0]),
         frame=list(rgb.shape), train_depth=w["train_depth"], t_at_level=list(w["cfg"].t_at_level),
         proposals={"bin": bin_idx.tolist(), "depth_mm": depths.tolist(), "pixels": counts.tolist(),
                    "scale": [float(v) for v in mc.bin_scales[bin_idx.long()].cpu() * (counts.cpu() > 0)]},
         coarse_kernel=list(mc.bank.kdims[-1]), pad_kb=list(mc.bank.pad_kb),
         launches=launches, coarse_launches=COARSE_BY_PHASE["match_ms"], frames=frames, live_into_pool_calls=live_in,
         kernel_call={"maps": list(low_pool[0]["maps"].shape), "feats": list(low_pool[0]["feats"].shape),
                      "t": low_pool[0]["t"], "scaled": True},
         thresholds=list(thresholds), live_per_class=live, matches={str(t): len(m) for t, m in matches.items()},
         gpu_equals_cpu=True, cpu_seconds_per_frame=cpu_s, sync_free_frame=True,
         rows_equal_multiscale_detector=rows_equal, best_per_class_low=best[str(LOW_THRESHOLD)][:3])
    return low_pool[-1], launches


def phase_ms_golden(dev):
    """The planted multi-scale golden of ``tools/torch_port_ms_golden.py`` on
    the card: ``MultiScaleDetector`` and ``MultiScaleMultiClass`` equal the
    JAX results on live entries, and the disc's top match is at its planted
    depth, scale and position."""
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "planted_ms_golden.npz"))
    cids = [str(c) for c in g["class_ids"]]
    det = Detector.read_classes(os.path.join(TESTDATA, "planted_mc_bank.npz"),
                                DetectorConfig(t_at_level=tuple(int(v) for v in g["t_at_level"])), device=dev)
    rgb, depth = synthetic.planted_scene_scaled(*(int(v) for v in g["scene_xy"]), float(g["planted_scale"]),
                                                int(g["scene_depth"]), seed=int(g["scene_seed"]))
    kw = dict(num_scales=int(g["num_scales"]), device=dev)
    thr = float(g["threshold"])
    single = MultiScaleDetector(det, float(g["train_depth"]), **kw).match_arrays(rgb, depth, thr, "disc")
    multi = MultiScaleMultiClass(det, float(g["train_depth"]), class_ids=cids, **kw).match_arrays(rgb, depth, thr)
    tops = {}
    for name, out, row in (("single", single, None), ("multi", multi, 0)):
        golden = [g[f"{name}_{k}"] for k in MS_OUT]
        check(same_live(golden[:5], out[:5]) and all(
            np.array_equal(golden[i][golden[3] >= 0], out[i].cpu().numpy()[golden[3] >= 0]) for i in (5, 6)),
            f"{name} differs from the JAX golden")
        tops[name] = _best(out, row)
        t = tops[name]
        check(t is not None and t[0] == 0 and t[4] == float(g["scene_depth"]) and t[5] == float(g["planted_scale"])
              and max(abs(t[1] - int(g["expected_xy"][0])), abs(t[2] - int(g["expected_xy"][1]))) <= int(g["tolerance_px"]),
              f"the disc's top {name} match {t} is not the planted one")
    emit("ms_golden", t0, equals_jax=True, top_match=tops, planted={"xy": g["expected_xy"].tolist(),
         "depth_mm": int(g["scene_depth"]), "scale": float(g["planted_scale"])})


def ms_stage_events(marks: list):
    """Events at the stage boundaries of the multi-scale cores: after the
    pyramid, after the proposals, after the coarse sweep, before and after
    the refinement (``MS_STAGES``)."""
    return wrapped_stages(M, marks, {"_build_response_pyramid": (False, True), "proposals": (False, True),
                                     "coarse_sweep": (False, True), "pyramid_refine": (True, True)})


def time_sweep(mc, rgb_t, dep_t, cfg) -> dict:
    """The full-width frame's coarse sweep (15 x 337 templates at 5
    proposals, the coarse-scorer kernel; CUDA events over whole eager
    calls) beside its bound and the dense conv of scaled kernels
    (``time_dense_conv``, over the valid proposals)."""
    t = cfg.t_at_level[-1]
    pyr = D.frame_response_pyramid(rgb_t, dep_t, cfg, rgb_t.device)
    _, _, valid, scales = M.proposals(dep_t, mc.bin_scales, mc.num_scales, mc.bins)
    pb, qb = mc.bank.pad_kb
    maps = torch.nn.functional.pad(pyr[-1], (0, qb * t, 0, pb * t))
    feats, valid_f = mc.bank.feats[-1], mc.bank.valids[-1]
    kh, kw = mc.bank.kdims[-1]
    scorer = lambda: similarity_multiscale_auto(maps, feats, valid_f, scales, t, kh, kw)  # noqa: E731
    raw, nf = scorer()
    p = raw.shape[-2] * raw.shape[-1]
    return {
        "maps": list(maps.shape), "rows": int(raw.shape[0]), "F": int(feats.shape[1]), "kernel": [kh, kw], "t": t,
        "placements": p,
        "scorer_ms": cuda_ms(scorer, reps=5),
        "library_ms": time_dense_conv(maps, feats, valid_f, torch.where(valid, scales, 0.0), t, kh, kw, raw),
        "bound": scorer_bound(maps, feats, nf, p),
    }


def time_refine_library(c, kh: int, kw: int, reps: int = 3, inner: int = 1) -> float:
    """One grouped ``F.conv2d`` computing the refine call ``c`` (each
    candidate's own kernel of extent (kh, kw), built from its features at
    its scale, as ``similarity_local``), ``inner`` calls replayed from a
    CUDA graph, median of ``reps``; checked against the kernel on live
    candidates."""
    scale = c["scale"][:, None] if c["scale"] is not None else 1.0
    kernels = build_kernels_scaled(c["feats"], c["valid"], scale, kh, kw, c["maps"].shape[0])
    lhs, rhs = _local_conv_operands(c["maps"][None], kernels[None], c["origins"][None], c["t"], c["window"])
    conv = lambda: torch.nn.functional.conv2d(lhs, rhs, groups=rhs.shape[0])  # noqa: E731
    live = c["active"]
    check(torch.equal(torch.round(conv())[0][live], _run(LR.similarity_local_sparse_cuda, c)[0][live]),
          "the grouped conv disagrees with the kernel on live candidates")
    ms = graph_ms(conv, reps=reps, inner=inner)
    del lhs, rhs, kernels
    torch.cuda.empty_cache()
    return ms


def timing_multiscale(dev, w, ms, ms_call) -> dict:
    """CUDA-event medians of the full-width multi-scale frame and of the
    single-class frame (its last class), whole (5 eager calls) and by stage (5,
    events at ``MS_STAGES``' boundaries), at 70 and LOW_THRESHOLD; the coarse
    sweep (``time_sweep``); the kernel at the K=1920 scaled call beside its
    bound, its plain version and one grouped conv."""
    rgb_t = torch.from_numpy(w["rgb"]).to(dev)
    dep_t = torch.from_numpy(w["depth"].astype(np.int32)).to(dev)
    mc, single = ms["card"], ms["single"]
    cid = mc.class_ids[-1]
    runs = {
        "one_pass": lambda t: mc.match_arrays(rgb_t, dep_t, t),
        "single_class": lambda t: single.match_arrays(rgb_t, dep_t, t, cid),
    }
    thresholds = (w["threshold"], LOW_THRESHOLD)
    out = {
        "frame_ms": {n: {str(t): cuda_ms(lambda t=t, r=r: r(t), reps=5) for t in thresholds} for n, r in runs.items()},
        "stage_ms": {n: {str(t): staged_ms(lambda t=t, r=r: r(t), 5, MS_STAGES, ms_stage_events) for t in thresholds}
                     for n, r in runs.items()},
        "single_class": cid,
    }
    torch.cuda.reset_peak_memory_stats()
    mc.match_arrays(rgb_t, dep_t, LOW_THRESHOLD)
    torch.cuda.synchronize()
    out["peak_memory_bytes_one_pass_frame"] = torch.cuda.max_memory_allocated()
    out["coarse_sweep"] = time_sweep(mc, rgb_t, dep_t, w["cfg"])
    out["refine_kernel_K1920_scaled"] = time_refine(ms_call)
    out["refine_kernel_K1920_scaled"]["library_grouped_conv_ms"] = time_refine_library(ms_call, *mc.bank.kdims[0])
    return out


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call to enqueue ``fn`` (calls back to back, no
    wait for the device between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def device_us_by_kernel(fn, n: int = 20) -> dict:
    """torch.profiler's device microseconds per call of ``fn``, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {r.key[:80]: r.self_device_time_total / n for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA}


def graph_ms(fn, reps: int, inner: int) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed back to back, median over ``reps`` CUDA-event windows.  Unlike
    ``cuda_ms`` this leaves out the host's launch overhead between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps) / inner


def refine_bound(c) -> dict:
    """Least bytes and operations of one local-refine call on these inputs:
    the map bytes its live in-range windows touch, the feature tables and
    the outputs, each once; one add per touched window cell.  Also the
    bytes of the 32-byte L2 sectors that the stride-t gather requests, one
    window row of one feature at a time (``gather_sector_bytes``): what the
    kernel moves through L2 when no sector is reused from L1."""
    single = c["maps"].dim() == 3
    maps, feats, valid, origins, scale, active = (
        x[None] if single and x is not None else x
        for x in (c["maps"], c["feats"], c["valid"], c["origins"], c["scale"], c["active"])
    )
    b, ch, h, w = maps.shape
    t, win = c["t"], c["window"]
    hb, wb = -(-h // t), -(-w // t)
    ok, cprime, by, bx = _feature_table(feats, valid, origins, t, hb, wb, scale)
    if active is not None:
        ok = ok & active[..., None]
    chan, dy, dx = cprime // (t * t), (cprime % (t * t)) // t, cprime % t
    steps = torch.arange(win, device=maps.device)
    rows = (by[..., None] + steps) * t + dy[..., None]  # (B, K, F, win)
    cols = (bx[..., None] + steps) * t + dx[..., None]
    cell = ok[..., None, None] & (rows[..., :, None] < h) & (cols[..., None, :] < w)
    frame = torch.arange(b, device=maps.device).view(b, 1, 1, 1, 1)
    addr = (((frame * ch + chan[..., None, None]) * h + rows[..., :, None]) * w + cols[..., None, :]).long()
    touched = torch.zeros(maps.numel(), dtype=torch.bool, device=maps.device)
    touched[addr[cell]] = True
    # A window row's in-map columns run from cols[..., 0] in steps of t <= 32
    # bytes, so it requests every sector from its first byte's to its last's.
    ncols = (cols < w).sum(-1)  # (B, K, F)
    row_base = ((frame[..., 0] * ch + chan[..., None]) * h + rows) * w  # (B, K, F, win)
    first = row_base + cols[..., :1]
    last = first + ((ncols - 1) * t)[..., None]
    row_live = ok[..., None] & (rows < h) & (ncols[..., None] > 0)
    sectors = int(((last // 32 - first // 32 + 1) * row_live).sum())
    k, f = feats.shape[1:3]
    per_cand = f * 12 + f + 8 + (4 if scale is not None else 0) + (1 if active is not None else 0)
    table_bytes = b * k * per_cand
    out_bytes = b * k * (win * win * 4 + 4)
    nbytes = int(touched.sum()) + table_bytes + out_bytes
    ops = int(cell.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "gather_sector_bytes": 32 * sectors}


def time_refine(c) -> dict:
    """The kernel on one call's inputs, replayed from a CUDA graph and
    launched from Python, beside its plain version and the bound."""
    def run_kernel():
        return _run(LR.similarity_local_sparse_cuda, c)

    maps = c["maps"] if c["maps"].dim() == 4 else c["maps"][None]
    n_cand = maps.shape[0] * c["feats"].shape[-3]
    kern_ms = graph_ms(run_kernel, reps=7, inner=100)
    bound = refine_bound(c)
    return {
        "maps": list(c["maps"].shape), "feats": list(c["feats"].shape), "t": c["t"],
        "live": int(c["active"].sum()) if c["active"] is not None else n_cand,
        "groups": LR.split_groups(n_cand, torch.cuda.get_device_properties(0).multi_processor_count),
        "kernel_ms": kern_ms,
        "kernel_eager_ms": cuda_ms(run_kernel, reps=7, inner=100),
        "plain_ms": graph_ms(lambda: _run(similarity_local_sparse, c), reps=7, inner=10),
        "bound": bound,
        "gather_sector_TB_per_s": bound["gather_sector_bytes"] / kern_ms / 1e9,
    }


def _marking(marks: list):
    """A wrapper maker: ``wrap(fn, before, after)`` records a CUDA event into
    ``marks`` before and/or after each call of ``fn``."""
    def mark():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append(event)

    def wrap(fn, before: bool, after: bool):
        def wrapped(*args, **kwargs):
            if before:
                mark()
            out = fn(*args, **kwargs)
            if after:
                mark()
            return out
        return wrapped

    return wrap


@contextmanager
def wrapped_stages(module, marks: list, points: dict):
    """Record a CUDA event before and/or after each call of ``module``'s
    functions named in ``points`` (name -> (before, after)), for the
    duration."""
    original = {n: getattr(module, n) for n in points}
    wrap = _marking(marks)
    for name, (before, after) in points.items():
        setattr(module, name, wrap(original[name], before, after))
    try:
        yield
    finally:
        for name, fn in original.items():
            setattr(module, name, fn)


def stage_events(marks: list, match: str = "detect_frame_core"):
    """Events at each stage boundary of ``detect_refine_core`` (or, with
    ``match="match_multiclass_core"``, of ``detect_refine_multiclass_core``):
    after the match, before the scene maps, and before and after ICP (the
    pipeline module's own names, wrapped for the duration)."""
    return wrapped_stages(P, marks, {match: (False, True), "backproject": (True, False), "icp_batch": (True, True)})


def staged_ms(call, reps: int, stages, events) -> dict:
    """Median ms of each of ``stages`` of ``call()`` over ``reps`` calls,
    between CUDA events recorded at the stage boundaries by ``events(marks)``
    (one event per boundary between consecutive stages)."""
    call()
    torch.cuda.synchronize()
    per = {s: [] for s in stages}
    for _ in range(reps):
        marks: list = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with events(marks):
            start.record()
            call()
            end.record()
        end.synchronize()
        bounds = [start, *marks, end]
        check(len(bounds) == len(stages) + 1, f"{len(bounds)} stage events for {len(stages)} stages")
        for stage, a, b in zip(stages, bounds, bounds[1:]):
            per[stage].append(a.elapsed_time(b))
    return {s: statistics.median(v) for s, v in per.items()}


def stage_ms(frame, reps: int, match: str = "detect_frame_core") -> dict:
    """Median ms of each of ``STAGES`` of the detect+refine frame
    ``frame()`` over ``reps`` frames."""
    return staged_ms(frame, reps, STAGES, lambda marks: stage_events(marks, match))


# Float operations per unit of work, counted from the code: per pixel of the
# scene maps (backproject, the normals' box filter and differences, the
# chroma blur and gradients), and per point and iteration of ICP with the
# colored term (transform, association, residuals, the per-point normal
# equations of the three terms, their fixed-order reduction).
SCENE_MAP_OPS_PER_PIXEL = 175
ICP_OPS_PER_POINT_ITER = 850


def refine_frame_bounds(h: int, w: int, k: int, n: int, icp: IcpConfig) -> dict:
    """Least time per frame on the card of the scene maps and of ICP of
    ``k`` candidates of ``n`` points for this run's shapes: the larger of
    bytes over the memory rate and float operations over the non-tensor
    float32 rate.

    Scene maps read the int32 depth and the RGB once and write the packed
    (H*W, 7) scene table and the (H*W, 6) chroma table once.  ICP reads the
    clouds (points, validity, chroma) and both tables once (a run's taps
    touch fewer rows, so this overstates its bytes) and writes the poses.
    """
    n_bi = max(0, min(icp.bilinear_iters, icp.max_iters))
    n_coarse = len(range(0, n, max(1, n // max(icp.coarse_points, 8))))
    point_iters = k * ((icp.max_iters - n_bi) * n_coarse + n_bi * n + n)
    out = {}
    for name, nbytes, ops in (
        ("scene_maps", h * w * (4 + 3 + 7 * 4 + 6 * 4), h * w * SCENE_MAP_OPS_PER_PIXEL),
        ("icp", k * n * (12 + 1 + 8) + h * w * 13 * 4 + k * (16 * 4 + 8), point_iters * ICP_OPS_PER_POINT_ITER),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        out[name] = {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def timing_multiclass(dev, w, mc, pipe, mc_call, full_case, lm_case) -> dict:
    """CUDA-event medians of the full-width multi-class match frame and of
    the fused multi-class frame (whole, and split by stage) at 55 and
    LOW_THRESHOLD, beside per-frame bounds of the scene maps and ICP; the
    kernel at the multi-class call; the coarse scorer at full width and at
    the LINEMOD-scale call."""
    rgb = torch.from_numpy(w["rgb"]).to(dev)
    dep = torch.from_numpy(w["depth"].astype(np.int32)).to(dev)
    thresholds = (w["threshold"], LOW_THRESHOLD)
    out = {
        "match_frame_ms": {str(t): cuda_ms(lambda t=t: mc.match_arrays(rgb, dep, t), reps=10) for t in thresholds},
        "fused_frame_ms": {str(t): cuda_ms(lambda t=t: pipe(rgb, dep, t), reps=5) for t in thresholds},
        "fused_stage_ms": {str(t): stage_ms(lambda t=t: pipe(rgb, dep, t), reps=5, match="match_multiclass_core") for t in thresholds},
    }
    k = len(pipe.class_ids) * w["max_refine"] * w["icp_seeds"]
    bounds = refine_frame_bounds(*rgb.shape[:2], k, w["num_points"], w["icp"])
    low = out["fused_stage_ms"][str(LOW_THRESHOLD)]
    for stage in ("scene_maps", "icp"):
        bounds[stage]["measured_ms_at_30"] = low[stage]
        bounds[stage]["times_bound"] = low[stage] / bounds[stage]["bound_ms"]
    out["fused_frame_bounds"] = bounds
    out["icp_candidates"] = k
    out["refine_kernel_K1152"] = time_refine(mc_call)
    out["refine_kernel_K1152"]["library_grouped_conv_ms"] = time_refine_library(mc_call, *mc.bank.kdims[0])
    out["coarse_scorer"] = {"full_width": time_scorer(*full_case), "linemod_15x337_vga": time_scorer(*lm_case)}
    return out


def phase_timing(dev, cid, det, frames, depths, calls, pool_case, refine_stage, multiclass, multiscale, synth):
    t0 = time.perf_counter()
    bank = det.device_bank(cid)
    rgb1 = torch.from_numpy(frames[0]).to(dev)
    dep1 = torch.from_numpy(depths[0].astype(np.int32)).to(dev)
    rgb4 = torch.from_numpy(frames).to(dev)
    dep4 = torch.from_numpy(depths.astype(np.int32)).to(dev)
    frame_b1 = cuda_ms(lambda: detect_frame_core(rgb1, dep1, bank, BENCH_CFG, 75.0), reps=20)
    frame_b4 = cuda_ms(lambda: detect_frame_core(rgb4, dep4, bank, BENCH_CFG, 75.0), reps=10) / 4

    # The detect+refine frame at B=1, whole and by stage.
    thresholds = (75.0, LOW_THRESHOLD)
    run = {t: TBN.refine_runner(dep1, bank, refine_stage, t) for t in thresholds}
    refine_frame = {str(t): cuda_ms(lambda t=t: run[t](rgb1), reps=20) for t in thresholds}
    refine_stages = {str(t): stage_ms(lambda t=t: run[t](rgb1), reps=10) for t in thresholds}
    bounds = refine_frame_bounds(*rgb1.shape[:2], refine_stage["max_refine"], refine_stage["fields"][0].shape[1],
                                 refine_stage["icp"])
    low = refine_stages[str(LOW_THRESHOLD)]
    for stage in ("scene_maps", "icp"):
        bounds[stage]["measured_ms_at_30"] = low[stage]
        bounds[stage]["times_bound"] = low[stage] / bounds[stage]["bound_ms"]

    # The kernel at three calls: the main path's level-0 call at threshold
    # LOW_THRESHOLD (the last single-frame call recorded), its B=4 call and
    # the K=1020, F=136 pool of kernel_parity.
    c = [c for c in calls if c["maps"].shape[0] == 1][-1]
    c = {n: v[0] if isinstance(v, torch.Tensor) else v for n, v in c.items()}  # the frame's (C, H, W) call
    c4 = [c for c in calls if c["maps"].shape[0] == 4][-1]
    refine = {"B1_level0": time_refine(c), "B4_level0": time_refine(c4), "pool_K1020_F136": time_refine(pool_case)}
    # At the B=1 call, one PyTorch call computing the same function: the
    # grouped conv of similarity_local over the candidates' kernels.
    lib_ms = time_refine_library(c, *bank.kdims[0], reps=7, inner=3)
    refine["B1_level0"]["library_grouped_conv_ms"] = lib_ms
    emit(
        "timing", t0, nvidia_smi=nvidia_smi(),
        detect_frame_core_ms_per_frame={"B1": frame_b1, "B4": frame_b4},
        detect_refine_core_ms_per_frame_B1=refine_frame,
        detect_refine_core_stage_ms_B1=refine_stages,
        refine_frame_bounds=bounds,
        refine=refine,
        multiclass=multiclass,
        multiscale=multiscale,
        synth=synth,
        method=("CUDA events, medians; detect_frame_core and detect_refine_core: whole eager calls (20, or 10 "
                "for the stage split, which records an event at each stage boundary); refine: 100 (kernel), "
                "10 (plain) or 3 (conv) calls replayed from one CUDA graph per window, warm L2 as on the "
                "main path; kernel_eager_ms: the same 100 launches issued from Python; multiclass: match frame 10, "
                "fused frame and its stage split 5 whole eager calls, coarse scorer 10 eager calls, dense conv 3 "
                "eager calls a 2,048-template conv, summed, grouped conv at K=1152 1 call replayed from one CUDA graph; multiscale: frames and their "
                "stage split 5 whole eager calls, coarse sweep 5 eager calls, dense conv as above, kernel as "
                "refine, grouped conv 1 call replayed from one CUDA graph; synth: the service's host stage means over "
                "the 20 served frames (ServiceMetrics), device ms per fused frame the median of 10 CUDA-event "
                "windows (benchmark.fused_device_ms_per_frame), render the median of 10 eager 16-view batches, "
                "training wall seconds per class"),
    )
    b1 = refine["B1_level0"]
    return b1["kernel_ms"], b1["plain_ms"], lib_ms, b1["bound"]


def phase_profile(name: str, frame, n: int = 3):
    """Where a frame's time goes: torch.profiler over ``n`` calls of
    ``frame()`` after warm-up.  Device time is the sum of kernel self times
    (one stream, so they do not overlap); the idle share is the rest of the
    profiled wall time, which the profiler itself lengthens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(n):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3 / n
    rows = prof.key_averages()
    dev_rows = [r for r in rows if r.device_type == DeviceType.CUDA]
    cpu_rows = [r for r in rows if r.device_type == DeviceType.CPU]

    def dev_us(r):
        return getattr(r, "self_device_time_total", 0.0)

    device_ms = sum(dev_us(r) for r in dev_rows) / 1e3 / n
    top_dev = sorted(dev_rows, key=dev_us, reverse=True)[:8]
    top_cpu = sorted(cpu_rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:8]
    emit(
        name, t0, frames=n, wall_ms_per_frame_profiled=wall_ms, device_ms_per_frame=device_ms,
        device_idle_share=1.0 - device_ms / wall_ms if wall_ms else None,
        kernel_launches_per_frame=sum(r.count for r in dev_rows) / n,
        top_device=[[r.key[:70], dev_us(r) / 1e3 / n, r.count / n] for r in top_dev],
        top_cpu_self=[[r.key[:70], r.self_cpu_time_total / 1e3 / n, r.count / n] for r in top_cpu],
    )


# -- render-trained banks, serving and the synthetic accuracy benchmark ------

SYNTH_IM = (320, 240)
SYNTH_RADIUS = 450.0  # the benchmark's training radius (benchmark.train_benchmark_bank)
# The JAX package's accuracy record (SYNTH_r05.json) and run_benchmark at its
# settings: 20 scenes, seed 0, 4 objects per scene, threshold 55, top_k 128,
# 96 hypotheses per class, 4 seeds with the flip, verify_tau 6.
SYNTH_RECORD = {"recall": 0.7532467532467533, "recall_vsd": 0.7792207792207793, "targets": 77}
SYNTH_SETTINGS = dict(num_scenes=20, min_n_views=80, im_size=SYNTH_IM, threshold=55.0, seed=0,
                      max_objects_per_scene=4, max_hyps=96, icp_seeds=4, seed_flip=True, verify_tau=6.0, top_k=128)
SYNTH_RECALL_FLOOR = 0.10  # below the record by more than this, the path is broken
CUT_VIEWS = 12  # the smallest view sphere (12 points x 5 tilts): the CPU side of train_synth


def render_cases(models, K, seed: int = 0, n: int = 16):
    """Per mesh, the training mesh at the benchmark radius and ``n`` poses
    drawn from ``seed`` (random rotations, the scenes' depth range)."""
    rng = np.random.default_rng(seed)
    cases = {}
    for cid, m in models.items():
        Rs = np.stack([random_rotation(rng) for _ in range(n)]).astype(np.float32)
        ts = np.stack([[rng.uniform(-40, 40), rng.uniform(-30, 30), rng.uniform(380, 520)] for _ in range(n)])
        cases[cid] = (TT.training_mesh(m, K, SYNTH_RADIUS), Rs, ts.astype(np.float32))
    return cases


def batch_renderer(model, mesh, K, device):
    """The training renderer of one mesh on ``device``: ``(Rs, ts) ->
    (rgb, depth)`` (texture-mapped for a textured model), as
    ``render_train_templates`` builds it."""
    pts, faces, colors, uv = mesh
    up = lambda a, dtype=np.float32: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype))).to(device)  # noqa: E731
    args = (up(pts), up(faces, np.int64))
    Kt = up(K)
    if uv is not None:
        uv_t, tex = up(uv), up(np.asarray(model["texture"], np.float32) / 255.0)
        return lambda Rs, ts: GR.render_textured(*args, uv_t, tex, Kt, Rs, ts, SYNTH_IM)
    col = up(colors / 255.0)
    return lambda Rs, ts: GR.render_rgb_depth(*args, col, Kt, Rs, ts, SYNTH_IM)


def phase_render(dev):
    """The nine benchmark meshes at 320 x 240: a batch of 16 poses each
    through ``render_depth_batch`` and the training renderer, and ``render``
    in all three modes, on the card against the port's CPU run (bitwise);
    the JAX golden's renders at 96 x 72 on the card (bitwise); one batch
    with every synchronizing call raising; ms per 16-view batch."""
    t0 = time.perf_counter()
    models = TB.make_models()
    K = TB.benchmark_K(SYNTH_IM)
    cases = render_cases(models, K)
    equal, hits = {}, {}

    def run(cid, mesh, Rs, ts, device):
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        pts, faces, Kt, Rt, tt = up(mesh[0].astype(np.float32)), up(mesh[1]), up(K.astype(np.float32)), up(Rs), up(ts)
        res = [GR.render_depth_batch(pts, faces, Kt, Rt, tt, SYNTH_IM), *batch_renderer(models[cid], mesh, K, device)(Rt, tt)]
        for mode in ("depth", "rgb+depth", "rgb"):
            r = GR.render(dict(models[cid]), SYNTH_IM, K, Rs[0].astype(np.float64), ts[0].astype(np.float64), mode=mode,
                          texture=models[cid].get("texture"), device=device)
            res += list(r) if isinstance(r, tuple) else [r]
        return [a.cpu() for a in res]

    for cid, (mesh, Rs, ts) in cases.items():
        out = {"card": run(cid, mesh, Rs, ts, dev), "cpu": run(cid, mesh, Rs, ts, "cpu")}
        equal[cid] = all(torch.equal(a, b) for a, b in zip(out["card"], out["cpu"]))
        hits[cid] = int((out["card"][0] > 0).sum())
        check(equal[cid], f"the render of {cid} on the card differs from the CPU")
        check(hits[cid] > 0, f"{cid} rendered nothing")
    g = np.load(os.path.join(TESTDATA, "synth_golden.npz"))
    jax_equal = []
    for i, (cid, m) in enumerate((c, m) for c, m in models.items() for _ in range(2)):
        Kj, size = g["render_K"], tuple(int(v) for v in g["render_size"])
        rgb, depth = GR.render(dict(m), size, Kj, g["render_R"][i], g["render_t"][i], mode="rgb+depth", device=dev)
        tex = GR.render(dict(m), size, Kj, g["render_R"][i], g["render_t"][i], mode="rgb", texture=m.get("texture"),
                        device=dev)
        jax_equal.append(np.array_equal(depth.cpu().numpy(), g["render_depth"][i])
                         and np.array_equal(rgb.cpu().numpy(), g["render_rgb"][i])
                         and np.array_equal(tex.cpu().numpy(), g["render_tex_rgb"][i]))
    check(all(jax_equal), f"renders on the card differ from the JAX golden: {jax_equal}")

    batch_ms = {}
    for cid in ("box", "texbox"):
        mesh, Rs, ts = cases[cid]
        fn = batch_renderer(models[cid], mesh, K, dev)
        Rt, tt = torch.from_numpy(Rs).to(dev), torch.from_numpy(ts).to(dev)
        fn(Rt, tt)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(Rt, tt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        batch_ms[cid] = {"faces": int(mesh[1].shape[0]), "ms_per_16_views": cuda_ms(lambda: fn(Rt, tt), reps=10)}
    emit("render", t0, card_equals_cpu_bitwise=equal, depth_hits_pose0=hits, card_equals_jax_golden=jax_equal,
         sync_free_batch=True, batch_ms=batch_ms, im_size=list(SYNTH_IM))
    return batch_ms


def phase_train_synth(dev, bank_path: str):
    """The full-width bank of the synthetic benchmark (9 classes,
    ``min_n_views`` 80, 320 x 240, top_k 128) trained on the card by
    ``train_benchmark_bank`` into ``bank_path``; and the textured box at
    ``CUT_VIEWS`` views trained on the card and on the CPU: the same
    templates and infos; then the full-width bank's checkpoint round trip
    (``bank_checkpoint_roundtrip``).  Returns the training seconds, the
    seconds per class and the restored bank."""
    t0 = time.perf_counter()
    models = TB.make_models()
    K = TB.benchmark_K(SYNTH_IM)
    cfg = TB.benchmark_config(SYNTH_SETTINGS["top_k"])
    seconds = {}
    original = TB.render_train_templates

    def timed(det, cid, *args, **kwargs):
        t = time.perf_counter()
        stats = original(det, cid, *args, **kwargs)
        seconds[cid] = time.perf_counter() - t
        return stats

    TB.render_train_templates = timed
    try:
        det, train_s = TB.train_benchmark_bank(models, K, SYNTH_IM, SYNTH_SETTINGS["min_n_views"], cfg,
                                               bank_path, verbose=False, device=dev)
    finally:
        TB.render_train_templates = original
    per_class = {cid: det.num_templates(cid) for cid in models}
    check(min(per_class.values()) > 0 and train_s > 0, f"training failed: {per_class}")

    cut = dict(radii=[SYNTH_RADIUS], min_n_views=CUT_VIEWS, im_size=SYNTH_IM, elev_range=(-0.5 * np.pi, 0.5 * np.pi),
               tilt_range=(-0.5 * np.pi, 0.5 * np.pi), tilt_step=0.2 * np.pi)
    banks = {}
    for device in (dev, "cpu"):
        d = Detector(cfg, device=device)
        banks[str(device)] = (TT.render_train_templates(d, "texbox", models["texbox"], K, device=device, **cut), d)
    (s_card, d_card), (s_cpu, d_cpu) = banks[str(dev)], banks["cpu"]
    same = s_card == s_cpu and all(
        all(np.array_equal(la.features, lb.features) and (la.width, la.height) == (lb.width, lb.height)
            for la, lb in zip(a, b))
        for a, b in zip(d_card.bank.templates["texbox"], d_cpu.bank.templates["texbox"])
    ) and all(
        ia.keys() == ib.keys() and all(np.asarray(ia[k]).dtype == np.asarray(ib[k]).dtype
                                       and np.array_equal(ia[k], ib[k]) for k in ia)
        for ia, ib in zip(d_card.bank.infos["texbox"], d_cpu.bank.infos["texbox"])
    )
    check(same and s_card["added"] > 0, f"the textured box trained on the card differs from the CPU: {s_card} {s_cpu}")
    restored, ckpt = bank_checkpoint_roundtrip(det.bank, os.path.join(os.path.dirname(bank_path), "synth_checkpoint"))
    emit("train_synth", t0, templates_per_class=per_class, templates=det.num_templates(), train_time_s=train_s,
         train_seconds_per_class=seconds, cut_texbox={"views": sum(s_card.values()), "stats": s_card,
                                                      "card_equals_cpu": True}, checkpoint=ckpt)
    return train_s, seconds, restored


def same_info(a: dict, b: dict) -> bool:
    """A trained template's info against the one restored from JSON (arrays
    as lists): the same keys, shapes and values, exactly."""
    return a.keys() == b.keys() and all(
        np.shape(a[k]) == np.shape(b[k]) and np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def bank_checkpoint_roundtrip(bank, ckpt_dir: str) -> tuple:
    """``save_checkpoint`` of the trained bank and ``load_checkpoint`` of it:
    the same classes, padded arrays to the bit and infos exactly.  Returns
    the restored bank, and the save and restore seconds and the bytes on
    disk."""
    t0 = time.perf_counter()
    bank.save_checkpoint(ckpt_dir)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = TemplateBank.load_checkpoint(ckpt_dir, bank.cfg)
    restore_s = time.perf_counter() - t0
    want, got = bank.to_padded_arrays(), back.to_padded_arrays()
    check(back.class_ids() == bank.class_ids() and all(
        got[cid][k].dtype == want[cid][k].dtype and np.array_equal(got[cid][k], want[cid][k])
        for cid in want for k in want[cid]), "the restored bank's padded arrays differ from the trained bank's")
    check(all(len(back.infos[cid]) == len(bank.infos[cid]) and all(map(same_info, bank.infos[cid], back.infos[cid]))
              for cid in bank.class_ids()), "the restored bank's infos differ from the trained bank's")
    sizes = {name: sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)
             for name, path in (("arrays", os.path.join(ckpt_dir, "arrays")), ("meta_json", ckpt_dir))}
    sizes["meta_json"] -= sizes["arrays"]
    shutil.rmtree(ckpt_dir)
    return back, {"save_s": save_s, "restore_s": restore_s, "bytes_on_disk": sizes, "classes": len(back.class_ids()),
                  "templates": back.num_templates(), "equals_trained": True, "synth_serves_it": True}


@contextmanager
def recording_services(services: list):
    """Keep every ``PoseEstimationService`` that ``run_benchmark`` builds."""
    original = TB.PoseEstimationService

    class Recording(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            services.append(self)

    TB.PoseEstimationService = Recording
    try:
        yield
    finally:
        TB.PoseEstimationService = original


def estimates_diff(ests, g, prefix: str, i: int) -> dict:
    """Published estimates against the golden's (``prefix`` arrays, row
    ``i``): count, class, template, x, y and similarity equal; the largest
    errors of R, t (mm), fitness and verify; within ``FUSED_TOL`` (fitness
    and verify within 0.01, two points of the smallest cloud)."""
    n = int(g[f"{prefix}_n"][i])
    ints = len(ests) == n and all(
        e.class_id == str(g[f"{prefix}_class"][i, j])
        and all(getattr(e, f) == g[f"{prefix}_{f}"][i, j] for f in ("template_id", "x", "y", "similarity"))
        for j, e in enumerate(ests))
    rows = range(min(len(ests), n))
    err = {
        "R": max((float(np.abs(ests[j].R - g[f"{prefix}_R"][i, j]).max()) for j in rows), default=0.0),
        "t_mm": max((float(np.abs(ests[j].t.ravel() - g[f"{prefix}_t"][i, j]).max()) for j in rows), default=0.0),
        "fitness": max((abs(ests[j].fitness - g[f"{prefix}_fitness"][i, j]) for j in rows), default=0.0),
        "verify": max((abs(ests[j].verify - g[f"{prefix}_verify"][i, j]) for j in rows), default=0.0),
    }
    within = ints and err["R"] <= FUSED_TOL["R"] and err["t_mm"] <= FUSED_TOL["t_mm"] and max(
        err["fitness"], err["verify"]) <= 0.01
    return {"ints_equal": bool(ints), "max_err": err, "within_tol": bool(within), "estimates": len(ests)}


def phase_synth_golden(dev):
    """``run_benchmark`` and ``PoseEstimationService`` on the card at the
    cut size of the golden of ``tools/torch_port_synth_golden.py``, over its
    JAX-trained bank: JAX's targets, hits, VSD hits and per-object recall;
    the service's estimates within ``FUSED_TOL`` of JAX's on the fused path
    (every scene), the host path and the multi-scale path."""
    t0 = time.perf_counter()
    g = np.load(os.path.join(TESTDATA, "synth_golden.npz"))
    settings, want = json.loads(str(g["settings"])), json.loads(str(g["result"]))
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "bank.npz")
        shutil.copy(os.path.join(TESTDATA, "synth_bank.npz"), cache)
        shutil.copy(os.path.join(TESTDATA, "synth_bank.npz.meta.json"), cache + ".meta.json")
        LR.similarity_local_sparse_cuda.launches = 0
        got = TB.run_benchmark(bank_cache=cache, verbose=False, device=dev, **settings)
        torch.cuda.synchronize()
        launches = LR.similarity_local_sparse_cuda.launches
    for key in ("targets", "hits", "hits_vsd", "per_object"):
        check(got[key] == want[key], f"run_benchmark on the card: {key} {got[key]}, JAX {want[key]}")
    # One refine launch per served frame (t_at_level (4, 8)): the scenes and
    # fused_device_ms_per_frame's warm-up and timed frames.
    check(launches == settings["num_scenes"] + 11, f"{launches} refine launches for {settings['num_scenes']} scenes")

    svc_cfg = json.loads(str(g["service"]))
    det = Detector.read_classes(os.path.join(TESTDATA, "synth_bank.npz"), TB.benchmark_config(settings["top_k"]),
                                device=dev)
    models = {c: TB.make_models()[c] for c in settings["object_ids"]}

    def service(**kw):
        return PoseEstimationService(
            det, models, TB.benchmark_K(tuple(settings["im_size"])), threshold=svc_cfg["threshold"],
            max_refine=svc_cfg["max_refine"], icp=IcpConfig(max_iters=svc_cfg["icp_max_iters"]),
            min_fitness=svc_cfg["min_fitness"], icp_seeds=svc_cfg["icp_seeds"], verify_tau=svc_cfg["verify_tau"],
            seed_flip=svc_cfg["seed_flip"], device=dev, **kw)

    fused = service()
    diffs = {f"fused_scene{i}": estimates_diff(fused.process_frame(g["rgb"][i], g["depth"][i]), g, "est", i)
             for i in range(settings["num_scenes"])}
    host = service(prefer_fused=False)
    diffs["host"] = estimates_diff(host.process_frame(g["rgb"][int(g["host_scene"])], g["depth"][int(g["host_scene"])]),
                                   g, "case", 0)
    ms = service()
    ms.enable_multiscale(train_depth=float(g["ms_train_depth"]), num_scales=int(g["ms_scales"]))
    diffs["multiscale"] = estimates_diff(ms.process_frame(g["rgb"][int(g["ms_scene"])], g["depth"][int(g["ms_scene"])]),
                                         g, "case", 1)
    for name, d in diffs.items():
        check(d["within_tol"], f"the service's {name} estimates differ from JAX's: {d}")
    emit("synth_golden", t0, launches=launches, result={k: got[k] for k in ("targets", "hits", "hits_vsd", "per_object")},
         equals_jax=True, estimates_vs_jax=diffs, tolerance=dict(FUSED_TOL, fitness=0.01, verify=0.01))
    return launches


@contextmanager
def serving_bank(bank):
    """``run_benchmark`` serves ``bank`` in place of the one
    ``train_benchmark_bank`` would read from its cache or train."""
    original = TB.train_benchmark_bank

    def restored(models, K, im_size, min_n_views, cfg, bank_cache=None, verbose=True, device=None):
        det = Detector(cfg, device=device)
        det.bank = bank
        return det, 0.0

    TB.train_benchmark_bank = restored
    try:
        yield
    finally:
        TB.train_benchmark_bank = original


def phase_synth(dev, bank, train_s: float):
    """``run_benchmark`` at the settings of ``SYNTH_r05.json`` on the card,
    serving the bank of ``train_synth`` restored from its checkpoint: its
    recall beside the record's, gated at the record minus
    ``SYNTH_RECALL_FLOOR`` and 77 +- 2 targets."""
    t0 = time.perf_counter()
    services: list = []
    LR.similarity_local_sparse_cuda.launches = 0
    with recording_services(services), serving_bank(bank):
        r = TB.run_benchmark(verbose=False, device=dev, **SYNTH_SETTINGS)
    torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    check(launches == SYNTH_SETTINGS["num_scenes"] + 11,
          f"{launches} refine launches for {SYNTH_SETTINGS['num_scenes']} scenes")
    line = {k: r[k] for k in ("recall", "recall_vsd", "targets", "hits", "hits_vsd", "per_object")}
    line.update(train_time_s=train_s, detect_refine_s_per_frame=r["detect_refine_s_per_frame"],
                device_ms_per_frame=r.get("device_ms_per_frame"), record_SYNTH_r05=SYNTH_RECORD)
    print(json.dumps({"synth": line}), flush=True)
    check(abs(r["targets"] - SYNTH_RECORD["targets"]) <= 2, f"{r['targets']} targets, the record has 77")
    for key in ("recall", "recall_vsd"):
        check(r[key] >= SYNTH_RECORD[key] - SYNTH_RECALL_FLOOR, f"{key} {r[key]} below the record's floor")
    emit("synth", t0, launches=launches, result=r, service_metrics=services[0].metrics.snapshot())
    return launches, services[0], r


def synth_scene(dev):
    """The benchmark's first full-width scene (seed 0, 4 objects), as numpy."""
    models = TB.make_models()
    rgb, depth, _ = TB.make_scene(models, TB.benchmark_K(SYNTH_IM), SYNTH_IM, np.random.default_rng(0),
                                  max_objects=SYNTH_SETTINGS["max_objects_per_scene"], device=dev)
    return rgb, depth


# -- the Latent-Class Hough Forest path ----------------------------------------

# The JAX tool's pose_eval configuration (tools/lchf_pipeline.py): the box,
# 320 x 240, f = 280, train radius 500, LchfConfig defaults, 50-px patches at
# stride 10, 5 trees, dense ROIs at stride 10, top 10 bins, 5 ICP seeds.  Its
# --views 20 samples 420 poses (42 points x 10 in-plane tilts) and
# --eval-views 12 samples 120: the phase trains on every 21st and evaluates
# every 10th (20 and 12 views).
LCHF_IM = (320, 240)
LCHF_K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1]])
LCHF_RADIUS = 500.0
LCHF_TRAIN_VIEWS, LCHF_EVAL_VIEWS = 20, 12
LCHF_ROI_STRIDE, LCHF_TOP_K, LCHF_ICP_SEEDS = 10, 10, 5
LCHF_CPU_PATCHES, LCHF_CPU_VIEWS = 200, 3  # the CPU reference's share
LCHF_CPU_THREADS = 4  # the CPU reference's worker leaves the other cores to the card's host work
# The JAX golden (tools/torch_port_lchf_golden.py, the configuration of
# tests/test_lchf.py::test_lchf_6d_pose_recall); the card extracts the
# patches of its first LCHF_GOLDEN_VIEWS training poses.
LCHF_GOLDEN = dict(im=(160, 120), K=np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]]), radius=420.0,
                   cfg=LchfConfig(num_features=6, extract_threshold=1, strong_threshold=30.0), patch=40, stride=12,
                   roi_stride=8, top_k=5, icp_seeds=5, step_iters=2, views=12)


def lchf_views():
    """(20 training views, 12 held-out views) of the pose_eval configuration."""
    train, _ = sample_views(LCHF_TRAIN_VIEWS, radius=LCHF_RADIUS)
    held, _ = sample_views(LCHF_EVAL_VIEWS, radius=LCHF_RADIUS)
    return train[:: len(train) // LCHF_TRAIN_VIEWS][:LCHF_TRAIN_VIEWS], held[:: len(held) // LCHF_EVAL_VIEWS][:LCHF_EVAL_VIEWS]


def lchf_render(mesh, im, K, view, device):
    rgb, depth = GR.render(mesh, im, K, view["R"], view["t"], mode="rgb+depth", device=device)
    return rgb.cpu().numpy(), depth.cpu().numpy().astype(np.uint16)


def kernel_launches(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(r.count for r in prof.key_averages() if r.device_type == DeviceType.CUDA))


def same_patches(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.features, y.features) and np.array_equal(x.z_rel, y.z_rel) and x.center_dep == y.center_dep
        and tuple(x.shape) == tuple(y.shape) and np.array_equal(x.responses, y.responses)
        and np.array_equal(x.z_avg, y.z_avg) for x, y in zip(a, b))


def forest_tables(forest) -> list:
    """Per tree: node table, thresholds and the leaves' samples."""
    return [(np.array([[nd.issplit, nd.pnode, nd.depth, *nd.cnodes, nd.isleafnode, nd.split_feat_idx] for nd in t.nodes],
                      np.int64),
             np.array([nd.simi_thresh for nd in t.nodes], np.float32),
             np.concatenate([t.nodes[i].ind_feats for i in t.id_leafnodes]))
            for t in forest.trees]


def same_forest(fa, fb) -> bool:
    ta, tb = forest_tables(fa), forest_tables(fb)
    return len(ta) == len(tb) and all(all(np.array_equal(x, y) for x, y in zip(a, b)) for a, b in zip(ta, tb))


def exact_phase_bins(device):
    """The ``phase="exact"`` orientation bins (and degrees) of every integer
    Sobel pair in [-1020, 1020]^2, as ``quantize_color_gradient`` bins them."""
    r = torch.arange(-1020, 1021, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    deg = Q.exact_atan2_deg(gy.reshape(-1), gx.reshape(-1))
    bins = torch.round(deg * Q._f32(16.0 / 360.0, device)).to(torch.int32) & 15
    return bins.cpu().numpy(), deg.cpu().numpy()


def refined_diff(a, b) -> dict:
    """Refined (R, t mm, fitness, verify) of two runs: largest differences,
    fitness and verify in points of their 512."""
    return {"R": float(np.abs(a[0] - b[0]).max(initial=0.0)), "t_mm": float(np.abs(a[1] - b[1]).max(initial=0.0)),
            "fitness_points": float(np.abs(a[2] - b[2]).max(initial=0.0) * 512),
            "verify_points": float(np.abs(a[3] - b[3]).max(initial=0.0) * 512),
            "bitwise": all(np.array_equal(x, y) for x, y in zip(a, b))}


def within_fused_tol(d: dict) -> bool:
    return all(d[k] <= FUSED_TOL[k] for k in FUSED_TOL)


def lchf_cpu_patches(frames: list, rotations: list, cfg: LchfConfig, at_least: int) -> list:
    """The CPU's training patches of the first views, ``at_least`` of them
    or more (a worker-process task)."""
    out = []
    for (rgb, depth), R in zip(frames, rotations):
        if len(out) >= at_least:
            break
        out += make_training_patches(rgb, depth, (depth > 0).astype(np.uint8) * 255, R, cfg, device="cpu")[0]
    return out


def lchf_cpu_forest(patches: list, rpy: np.ndarray, z_check: float):
    """The CPU's similarity matrix and the forest ``train_forest(on_device=True)``
    trains from it (its defaults: 5 trees, bagging 0.8, seed 0); a
    worker-process task."""
    sim = similarity_matrix_device(patches, PatchSet.from_features(patches), z_check, "cpu")
    forest = Forest()
    forest.train(lambda pivot, members: sim[pivot, np.asarray(members)], rpy)
    return sim, forest


def lchf_views_on(model, mesh, frames: list, cfg: LchfConfig, depth_offset: float, device) -> list:
    """(votes front, hypotheses, refined poses) of each frame with the walk
    on ``device`` (the CPU's run is a worker-process task)."""
    out = []
    for rgb, depth in frames:
        front = lchf_vote_bins(model, rgb, depth, LCHF_RADIUS, cfg, LCHF_ROI_STRIDE, top_k=LCHF_TOP_K, on_device=True,
                               device=device)
        hyps = decode_bin_poses(front["bins"], *front["vote_arrays"], LCHF_K, LCHF_RADIUS, depth_offset=depth_offset)
        out.append((front, hyps, refine_lchf_poses(hyps, mesh, depth, LCHF_K, None, icp_seeds=LCHF_ICP_SEEDS,
                                                   device=device)))
    return out


def phase_lchf(dev) -> tuple:
    """The LCHF path at the pose_eval configuration on the card: the
    exact-phase bins of every Sobel pair, training patches, the similarity
    matrix, the forest (trained from the card's matrix), and
    ``evaluate_pose_recall`` over the held-out views with the forest walk
    on the card, each held against the port's CPU run (patches on the first
    ``LCHF_CPU_PATCHES``, votes to refined poses on ``LCHF_CPU_VIEWS`` views),
    which a spawned worker computes while the card works; then the JAX
    golden.  Prints ``{"lchf": ...}``."""
    t0 = time.perf_counter()
    marks = {}

    def mark(step):
        marks[step] = time.perf_counter() - t0 - sum(marks.values())

    card_bins, card_deg = exact_phase_bins(dev)
    cpu_bins, cpu_deg = exact_phase_bins("cpu")
    enum = {"pairs": int(card_bins.size), "bins_differing": int((card_bins != cpu_bins).sum()),
            "degrees_differing": int((card_deg != cpu_deg).sum())}
    check(enum["bins_differing"] == 0, f"exact-phase bins on the card differ from the CPU: {enum}")
    mark("enumeration")

    mesh = TB.make_models()["box"]
    cfg = LchfConfig()
    train_views, eval_views = lchf_views()
    frames = [lchf_render(mesh, LCHF_IM, LCHF_K, v, dev) for v in train_views]
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(LCHF_CPU_THREADS,))
    try:
        cpu_patches = pool.submit(lchf_cpu_patches, frames, [v["R"] for v in train_views], cfg, LCHF_CPU_PATCHES)
        LR.similarity_local_sparse_cuda.launches = 0
        w0 = time.perf_counter()
        per_view = []
        for (rgb, depth), v in zip(frames, train_views):
            per_view.append(make_training_patches(rgb, depth, (depth > 0).astype(np.uint8) * 255, v["R"], cfg,
                                                  device=dev))
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - w0
        patches = [p for f, _, _ in per_view for p in f]
        rpys = np.asarray([r for _, rs, _ in per_view for r in rs], np.float32)
        ts = np.asarray([t for _, _, tl in per_view for t in tl], np.float32)
        cpu_patches = cpu_patches.result()
        check(len(cpu_patches) >= LCHF_CPU_PATCHES, f"only {len(cpu_patches)} CPU patches")
        check(same_patches(patches[: len(cpu_patches)], cpu_patches), "training patches on the card differ from the CPU")
        rgb0, depth0 = frames[0]
        ys, xs = np.nonzero(depth0)
        y0, x0 = int(ys.min()), int(xs.min())
        crop = (slice(y0, y0 + 50), slice(x0, x0 + 50))
        extract_launches = kernel_launches(
            lambda: extract_patch_feature(rgb0[crop], depth0[crop], (depth0[crop] > 0).astype(np.uint8) * 255, cfg,
                                          True, device=dev))
        mark("training_set")

        cpu_forest = pool.submit(lchf_cpu_forest, patches, rpys, cfg.z_check)
        pset = PatchSet.from_features(patches)
        droi = DeviceRoiSet(pset, patches, cfg.z_check, dev)
        s_card = droi.matrix().cpu().numpy()
        sim_ms = cuda_ms(droi.matrix, reps=3)
        piv = droi.pivots
        sim_bytes = (pset.responses.nbytes + pset.z_avg.nbytes + pset.center.nbytes + s_card.nbytes
                     + sum(x.numel() * x.element_size() for x in (piv.feats, piv.valid, piv.zrel, piv.center, piv.shape)))
        w0 = time.perf_counter()
        model = train_forest(patches, rpys, ts, cfg, on_device=True, device=dev)
        train_s = time.perf_counter() - w0
        s_cpu, forest_cpu = cpu_forest.result()
        check(np.array_equal(s_card, s_cpu), "the similarity matrix on the card differs from the CPU")
        check(same_forest(model.forest, forest_cpu), "the forest trained from the card's matrix differs")
        mark("matrix_and_forest")

        depth_offset = float(LCHF_RADIUS - np.mean([p.center_dep for p in model.patches]))
        view_frames = [lchf_render(mesh, LCHF_IM, LCHF_K, v, dev) for v in eval_views[:LCHF_CPU_VIEWS]]
        cpu_views = pool.submit(lchf_views_on, model, mesh, view_frames, cfg, depth_offset, "cpu")
        # The main path: evaluate_pose_recall (the forest walk on the card)
        # over the held-out views, refine launch counts set to 0 just before.
        LR.similarity_local_sparse_cuda.launches = 0
        w0 = time.perf_counter()
        res = evaluate_pose_recall(model, mesh, LCHF_K, LCHF_IM, eval_views, LCHF_RADIUS, cfg, stride=LCHF_ROI_STRIDE,
                                   top_k=LCHF_TOP_K, icp_seeds=LCHF_ICP_SEEDS, on_device=True, device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - w0
        launches = LR.similarity_local_sparse_cuda.launches
        check(res["n_views"] == LCHF_EVAL_VIEWS, f"{res['n_views']} views evaluated")
        card_views = lchf_views_on(model, mesh, view_frames, cfg, depth_offset, dev)
        compared = []
        for (fa, ha, ra), (fb, hb, rb) in zip(card_views, cpu_views.result()):
            for key in ("rois", "leaves", "votes", "bins"):
                check(np.array_equal(np.asarray(fa[key]), np.asarray(fb[key])), f"LCHF {key} on the card differ from the CPU")
            check(len(ha) == len(hb) and all(all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(ha, hb)),
                  "decoded LCHF hypotheses on the card differ from the CPU")
            diff = refined_diff(ra, rb)
            check(within_fused_tol(diff), f"refined LCHF poses on the card differ from the CPU: {diff}")
            compared.append({"rois": int(len(fa["rois"])), "votes": int(len(fa["vote_arrays"][0])),
                             "hypotheses": len(ha), "refined_vs_cpu": diff})
        mark("evaluation")
    finally:
        pool.shutdown(cancel_futures=True)

    # Stage times on the first held-out view.
    rgb, depth = lchf_render(mesh, LCHF_IM, LCHF_K, eval_views[0], dev)
    rois = dense_rois(depth, stride=LCHF_ROI_STRIDE, device=dev)
    roi_set = scene_roi_set(rgb, depth, rois, cfg, dev)
    forest = DeviceForest(model, cfg.z_check, dev)
    front = lchf_vote_bins(model, rgb, depth, LCHF_RADIUS, cfg, LCHF_ROI_STRIDE, top_k=LCHF_TOP_K, on_device=True,
                           device=dev)
    vote_shape = (LCHF_IM[0] // 10, LCHF_IM[1] // 10, 10, 10, 10)
    hyps = decode_bin_poses(front["bins"], *front["vote_arrays"], LCHF_K, LCHF_RADIUS, depth_offset=depth_offset)
    votes = lambda: accumulate_votes(*front["vote_arrays"], LCHF_RADIUS, vote_shape, device=dev)  # noqa: E731
    refine = lambda: refine_lchf_poses(hyps, mesh, depth, LCHF_K, None, icp_seeds=LCHF_ICP_SEEDS, device=dev)  # noqa: E731
    stages = {
        "walk_ms_per_scene": cuda_ms(lambda: forest.predict_tensor(roi_set), reps=3),
        "walk_launches_per_scene": kernel_launches(lambda: forest.predict_tensor(roi_set)),
        "walk_steps": forest.max_depth * len(forest.tables.trees),
        "vote_ms": cuda_ms(votes, reps=3),
        "vote_launches": kernel_launches(votes),
        "icp_ms_per_view": cuda_ms(refine, reps=3),
        "icp_candidates": len(hyps) * LCHF_ICP_SEEDS,
    }
    mark("stage_times")
    golden = phase_lchf_golden(dev)
    mark("golden")
    line = {
        "exact_phase_enumeration": enum,
        "train_views": len(train_views), "patches": len(patches), "extraction_s": extract_s,
        "extraction_ms_per_patch": extract_s * 1e3 / len(patches), "extraction_launches_per_patch": extract_launches,
        "cpu_patches_compared": len(cpu_patches),
        "similarity_matrix": {"shape": list(s_card.shape), "ms": sim_ms, "bytes": sim_bytes,
                              "bound_ms": sim_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"},
        "forest_train_s_host": train_s, "trees_nodes": [len(t.nodes) for t in model.forest.trees],
        "eval_views": res["n_views"], "eval_s_per_view": eval_s / res["n_views"], "recall_add_s": res["recall"],
        "errors_mm": [r.get("err_mm") for r in res["records"]],
        "cpu_views_compared": compared, **stages, "refine_kernel_launches": launches, "golden": golden,
        "host_s_by_step": marks,
    }
    print(json.dumps({"lchf": line}), flush=True)
    emit("lchf", t0, **line)
    return launches, line


def golden_forest(g: dict, prefix: str, num_trees: int) -> Forest:
    """A forest rebuilt from the golden's node tables, thresholds and the
    leaves' samples (enough to predict)."""
    forest = Forest(num_trees=num_trees)
    for ti, tree in enumerate(forest.trees):
        nodes, thresh = g[f"{prefix}{ti}_nodes"], g[f"{prefix}{ti}_thresh"]
        leaf_ids = np.split(g[f"{prefix}{ti}_leaf_ids"], np.cumsum(g[f"{prefix}{ti}_leaf_count"])[:-1])
        tree.nodes = [Node(issplit=bool(r[0]), pnode=int(r[1]), depth=int(r[2]), cnodes=(int(r[3]), int(r[4])),
                           isleafnode=bool(r[5]), split_feat_idx=int(r[6]), simi_thresh=float(th))
                      for r, th in zip(nodes, thresh)]
        tree.id_leafnodes = [i for i, nd in enumerate(tree.nodes) if nd.isleafnode]
        for i, ids in zip(tree.id_leafnodes, leaf_ids):
            tree.nodes[i].ind_feats = ids
    return forest


def golden_patches(g: dict) -> list:
    feats = np.split(g["features"], np.cumsum(g["feat_count"])[:-1])
    zrel = np.split(g["z_rel"], np.cumsum(g["feat_count"])[:-1])
    return [PatchFeature(features=f, z_rel=z, center_dep=float(c), responses=None, z_avg=None, shape=tuple(s))
            for f, z, c, s in zip(feats, zrel, g["center_dep"], g["shape"])]


def golden_top_bins_ok(bins, votes, g_bins, g_scores, top_k) -> bool:
    """``bins`` a valid top-``top_k`` of ``votes`` with the golden's scores
    (numpy's unstable argsort may order equal sums otherwise elsewhere)."""
    bins = np.asarray(bins)
    scores = votes[tuple(bins.T)] if len(bins) else np.zeros(0, np.float32)
    if not np.array_equal(scores, g_scores) or len({tuple(b) for b in bins}) != len(bins):
        return False
    last = g_scores[-1] if len(g_scores) == top_k else None
    return all({tuple(b) for b, x in zip(bins, scores) if x == s} == {tuple(b) for b, x in zip(g_bins, g_scores) if x == s}
               for s in np.unique(g_scores) if s != last)


def phase_lchf_golden(dev) -> dict:
    """The JAX golden on the card (tools/torch_port_lchf_golden.py): the
    training patches of its first poses, the similarity rows of its first
    pivots against them, and, with its host-route forest, every evaluated
    view: renders, ROIs, both routes' leaves, the vote tensor and top bins
    exactly, its bins decoded exactly, the refine stage within ``FUSED_TOL``
    at two ICP iterations, the best hypothesis and the hits at 20."""
    c = LCHF_GOLDEN
    with np.load(os.path.join(TESTDATA, "lchf_golden.npz")) as z:
        g = {k: z[k] for k in z.files}
    mesh = TB.make_models()["box"]
    views, _ = sample_views(8, radius=c["radius"])
    cfg = c["cfg"]
    feats = []
    for v in views[: c["views"]]:
        rgb, depth = lchf_render(mesh, c["im"], c["K"], v, dev)
        feats += make_training_patches(rgb, depth, (depth > 0).astype(np.uint8) * 255, v["R"], cfg, c["patch"],
                                       c["stride"], device=dev)[0]
    n = len(feats)
    check(n == int(g["patches_per_view"][: c["views"]].sum()), f"{n} golden patches on the card")
    ref = golden_patches(g)[:n]
    check(all(np.array_equal(a.features, b.features) and np.array_equal(a.z_rel, b.z_rel)
              and a.center_dep == b.center_dep and tuple(a.shape) == tuple(b.shape) for a, b in zip(feats, ref))
          and np.array_equal([f.responses.astype(np.int64).sum() for f in feats], g["resp_sum"][:n])
          and np.array_equal([f.z_avg.astype(np.float64).sum() for f in feats], g["zavg_sum"][:n])
          and np.array_equal(np.stack([f.responses for f in feats[: len(g["responses_head"])]]), g["responses_head"])
          and np.array_equal(np.stack([f.z_avg for f in feats[: len(g["zavg_head"])]]), g["zavg_head"]),
          "golden training patches differ on the card")
    rows = len(g["sim_head"])
    sims = DeviceRoiSet(PatchSet.from_features(feats), feats[:rows], cfg.z_check, dev).matrix().cpu().numpy()
    check(np.array_equal(sims, g["sim_head"][:, :n]), "golden similarity rows differ on the card")

    model = LchfModel(forest=golden_forest(g, "host_tree", 2), patches=golden_patches(g), patch_set=None,
                      rpy=g["rpy"], t=g["t"])
    depth_offset = float(c["radius"] - np.mean(g["center_dep"]))
    threshold_mm = 0.1 * model_diameter(mesh["pts"])
    out = {"patches_compared": n, "sim_rows_compared": [rows, n], "views": []}
    hits = []
    for vi in range(3):
        gv = {k[len(f"v{vi}_"):]: a for k, a in g.items() if k.startswith(f"v{vi}_")}
        rgb, depth = lchf_render(mesh, c["im"], c["K"], views[vi], dev)
        check(np.array_equal(rgb, gv["rgb"]) and np.array_equal(depth, gv["depth"]), "golden renders differ")
        kw = dict(stride=c["roi_stride"], top_k=c["top_k"], device=dev)
        front = lchf_vote_bins(model, rgb, depth, c["radius"], cfg, **kw)
        front_walk = lchf_vote_bins(model, rgb, depth, c["radius"], cfg, on_device=True, **kw)
        flat = front["votes"].reshape(-1)
        check(np.array_equal(front["rois"], gv["rois"]) and np.array_equal(front["leaves"], gv["leaves"])
              and np.array_equal(front_walk["leaves"], gv["leaves_jit"])
              and np.array_equal(np.nonzero(flat)[0], gv["votes_idx"]) and np.array_equal(flat[gv["votes_idx"]], gv["votes_val"]),
              f"golden view {vi}: ROIs, leaves or votes differ on the card")
        order_same = np.array_equal(front["bins"], gv["bins"])
        check(golden_top_bins_ok(front["bins"], front["votes"], gv["bins"], gv["scores"], c["top_k"]),
              f"golden view {vi}: top bins differ")
        hyps = decode_bin_poses(gv["bins"], *front["vote_arrays"], c["K"], c["radius"], depth_offset=depth_offset)
        check(all(np.array_equal(np.array([h[k] for h in hyps]), gv[name]) for k, name in
                  (("R", "hyp_R"), ("t", "hyp_t"), ("weight", "hyp_weight"), ("center_px", "hyp_center"))),
              f"golden view {vi}: hypotheses differ on the card")
        step = refine_lchf_poses(hyps, mesh, depth, c["K"], IcpConfig(max_iters=c["step_iters"]),
                                 icp_seeds=c["icp_seeds"], device=dev)
        d_step = refined_diff(step, [gv[f"step_{k}"] for k in ("R", "t", "fitness", "verify")])
        check(within_fused_tol(d_step), f"golden view {vi}: the refine stage differs from JAX's: {d_step}")
        full = refine_lchf_poses(hyps, mesh, depth, c["K"], None, icp_seeds=c["icp_seeds"], device=dev)
        best = int(np.argmax(full[3] * 100.0 + np.maximum(full[2], 0.0)))
        check(best == int(gv["best"]), f"golden view {vi}: best hypothesis {best}, JAX's {int(gv['best'])}")
        err = pose_error.adi(full[0][best], full[1][best].reshape(3, 1), views[vi]["R"],
                             np.asarray(views[vi]["t"]).reshape(3, 1), mesh, max_pts=1024, device=dev)
        hits.append(err < threshold_mm)
        check(hits[-1] == (float(gv["err"]) < threshold_mm), f"golden view {vi}: error {err} mm, JAX's {float(gv['err'])}")
        out["views"].append({"argsort_order_as_golden": bool(order_same), "err_mm": err, "jax_err_mm": float(gv["err"]),
                             "refine_2_iters_vs_jax": d_step,
                             "refine_20_iters_vs_jax": refined_diff(full, [gv[k] for k in ("R", "t", "fitness", "verify")])})
    out["recall"] = sum(hits) / len(hits)
    check(out["recall"] == float(g["recall"]), f"golden recall {out['recall']}, JAX's {float(g['recall'])}")
    return out


# -- the 3-D convex segmentation and registration path ----------------------

# The bin-picking frame at full width: VGA, f = 545 (DaspConfig's default
# camera), the nine meshes over a tilted floor (synthetic.bin_picking_scene);
# DaspConfig and pose_estimation defaults.  The JAX golden is the same
# recipe at 320 x 240 (tools/torch_port_seg_golden.py).
SEG_IM = (640, 480)
SEG_FOCAL = 545.0
SEG_SEED_PAD = 128
SEG_CPU_THREADS = 4  # the CPU reference's worker leaves the other cores to the card's host work
SEG_REPS = 3
SEG_REPLACES = {
    "segment_sum": "no TPU kernel: XLA's segment_sum at sixdpose_tpu/seg/dasp.py:307,310 and seg/slic.py:149,152",
    "floyd_steinberg": "no TPU kernel: native_bridge.floyd_steinberg (host C++) at sixdpose_tpu/seg/dasp.py:154",
}


def seg_config(K: np.ndarray) -> SegConfig:
    return SegConfig(focal_px=float(K[0, 0]), cx=float(K[0, 2]), cy=float(K[1, 2]))


def covering_segment(segments: np.ndarray, mask: np.ndarray) -> int:
    """The segment covering most of a visible mask (-1 when none does)."""
    ids = segments[mask]
    ids = ids[ids >= 0]
    return int(np.bincount(ids).argmax()) if len(ids) else -1


def seg_registrations(world: np.ndarray, segments: np.ndarray, masks, model_points, device) -> list:
    """pose_estimation (defaults, method "auto") of each object's covering
    segment in mm against its model cloud: [(segment, points, T, lcp)]."""
    out = []
    for mask, pts in zip(masks, model_points):
        s = covering_segment(segments, mask)
        cloud = world[segments == s] * 1000.0 if s >= 0 else np.zeros((0, 3), np.float32)
        if len(cloud) == 0:
            out.append((s, 0, np.zeros((4, 4)), 0.0))
            continue
        T, lcp = seg_pose_estimation(cloud, pts, device=device)
        out.append((s, len(cloud), T, lcp))
    return out


def seg_outputs(rgb, depth, K, masks, model_points, device) -> dict:
    """Every stage's output of the seg path on ``device``, as numpy: the
    pixel maps, seeds, ALIC indices and means, segments (``convex_cloud_seg``'s
    stages) and the registrations (a worker-process task on the CPU)."""
    cfg = seg_config(K)
    px, seeds, indices, sp = superpixel_stage(rgb, depth, cfg, SEG_SEED_PAD, device)
    px = {k: v.cpu().numpy() for k, v in px.items()}
    sp = {k: np.ascontiguousarray(v.cpu().numpy()) for k, v in sp.items()}
    segments = seg_convex_grouping(indices.cpu().numpy(), sp["world"], sp["normal"], sp["num"], cfg)
    return {"px": px, "seeds": seeds.cpu().numpy(), "indices": indices.cpu().numpy(), "sp": sp, "segments": segments,
            "registrations": seg_registrations(px["world"], segments, masks, model_points, device)}


def same_registrations(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2]) and x[3] == y[3]
                                    for x, y in zip(a, b))


def count_syncs(fn) -> int:
    """Device-to-host waits of one call: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, one per synchronising op."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def segment_sum_cases(rng) -> list:
    """(name, vals (N, C), ids, S) edge cases of the segment-sum kernel
    (``tests/test_torch_cuda.py`` holds the same): the longest chain (one
    segment holding every row), C = 1 and 13, rows that are not a multiple
    of the layout's tile, every id out of range, S above 1,024 (counters past
    48 KB of shared memory, and at the limit), an empty segment, one
    segment, nearly a segment a row, no rows."""
    cases = []
    for name, n, c, s in (("one_segment_every_row", 60_000, 13, 1), ("c1", 5000, 1, 64),
                          ("rows_not_a_tile_multiple", 8 * 1024 + 1, 13, 77), ("short", 31, 3, 5),
                          ("every_id_out_of_range", 3000, 13, 40), ("s_above_1024", 20_000, 13, 3000),
                          ("s_past_48kb_of_counters", 50_000, 2, 20_000), ("s_at_the_limit", 70_000, 1, SS.MAX_SEGMENTS),
                          ("empty_segment", 1000, 13, 40), ("one_segment", 4097, 3, 1), ("dense_segments", 513, 7, 300),
                          ("no_rows", 0, 13, 5)):
        vals = (rng.normal(0, 1, (n, c)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
        if name == "one_segment_every_row":
            ids = np.zeros(n, np.int64)
        elif name == "every_id_out_of_range":
            ids = np.where(rng.random(n) < 0.5, -1 - rng.integers(0, 5, n), s + rng.integers(0, 5, n))
        else:
            ids = rng.integers(-1, s + 1, n)
            if name == "empty_segment":
                ids[ids == 3] = 4
        cases.append((name, vals, ids.astype(np.int32 if c == 1 else np.int64), s))
    return cases


def segment_sum_checks(dev, pix: torch.Tensor, ids: torch.Tensor, s: int) -> dict:
    """The segment-sum kernel against its plain version on the card (to
    the bit), and its layout against the plain layout (``csr_layout``), at
    the main path's inputs and at the edge cases; timed at the main path's
    inputs: the whole call, the layout alone and the sums alone, beside the
    plain version, one ``index_add_`` and the bytes bound."""
    worst = 0.0
    cases = [("frame", pix, ids, s)] + [(name, torch.from_numpy(v).to(dev), torch.from_numpy(i).to(dev), n_seg)
                                        for name, v, i, n_seg in segment_sum_cases(np.random.default_rng(0))]
    for name, v, i, n_seg in cases:
        got = SS.segment_sum(v, i, n_seg)
        want = SS.segment_sum_plain(v, i, n_seg)
        check(torch.equal(got, want), f"segment_sum kernel differs from its plain version at {name}")
        worst = max(worst, float((got - want).abs().max()) if got.numel() else 0.0)
        order, starts, counts = SS.csr_layout(i, n_seg)
        got_order, got_starts = SS.segment_layout(i, n_seg)
        kept = int(counts.sum())
        check(int(got_starts[-1]) == kept and torch.equal(got_order[:kept].long(), order[:kept])
              and torch.equal(got_starts[:-1].long(), starts), f"segment_layout differs from csr_layout at {name}")
    keep = (ids >= 0) & (ids < s)
    safe = torch.where(keep, ids, torch.full_like(ids, s)).to(torch.int64)

    def library():
        return torch.zeros((s + 1, pix.shape[1]), dtype=torch.float32, device=dev).index_add_(0, safe, pix)[:s]

    order, starts = SS.segment_layout(ids, s)
    n_bytes = pix.numel() * 4 + ids.numel() * ids.element_size() + s * pix.shape[1] * 4
    whole = lambda: SS.segment_sum(pix, ids, s)  # noqa: E731
    # The whole call and index_add_ in turns, so that a drift of the host's
    # speed (both are bound by the host's launches) falls on both alike.
    turns = [(cuda_ms(whole, reps=10), cuda_ms(library, reps=10)) for _ in range(4)]
    return {"max_abs_err": worst, "shape": [int(pix.shape[0]), int(pix.shape[1]), s],
            "ids": str(ids.dtype), "edge_cases": [c[0] for c in cases[1:]],
            "ms": statistics.median(t[0] for t in turns), "turns_ms_whole_library": turns,
            "split_ms": {"layout": cuda_ms(lambda: SS.segment_layout(ids, s), reps=20),
                         "sums": cuda_ms(lambda: SS.segment_sums(pix, order, starts), reps=20),
                         "whole": cuda_ms(whole, reps=20),
                         "whole_graph": graph_ms(whole, reps=5, inner=20),
                         "library_graph": graph_ms(library, reps=5, inner=20),
                         "device_us_by_kernel": device_us_by_kernel(whole),
                         "host_us": {"whole": host_us(whole), "layout": host_us(lambda: SS.segment_layout(ids, s)),
                                     "sums": host_us(lambda: SS.segment_sums(pix, order, starts)),
                                     "library": host_us(library),
                                     "torch_empty": host_us(lambda: torch.empty((s, pix.shape[1]), device=dev))}},
            "plain_ms": cuda_ms(lambda: SS.segment_sum_plain(pix, ids, s), reps=3),
            "library_ms": statistics.median(t[1] for t in turns),
            "library_max_abs_diff": float((library() - SS.segment_sum(pix, ids, s)).abs().max()),
            "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def floyd_steinberg_cases(rng) -> list:
    """(name, density) edge cases of the seeding kernel
    (``tests/test_torch_cuda.py`` holds the same): dense seeds, values
    exactly one half, H = 1 and W = 1, odd heights and widths, the widest
    width the kernel's shared memory holds."""
    cases = [(f"{h}x{w}@{sc}", (rng.random((h, w)) * sc).astype(np.float32))
             for h, w, sc in ((1, 9, 0.4), (37, 51, 0.05), (121, 163, 0.3), (479, 641, 0.01), (64, 80, 0.95),
                              (1, 700, 0.95), (33, 47, 1.0), (5, 301, 0.02), (9, 1, 0.6), (1, 1, 0.7),
                              (3, FSK.MAX_WIDTH, 0.05))]
    for h, w in ((4, 32), (5, 33), (6, 64), (3, 1)):
        d = np.full((h, w), 0.5, np.float32)
        d[1::2, ::3] = 0.25
        cases.append((f"{h}x{w}@half", d))
    return cases


def floyd_steinberg_checks(dev, density: torch.Tensor) -> dict:
    """The seeding kernel against its plain version (the host scan) at the
    main path's density and at the edge cases, to the bit, and timed beside
    it, the bytes bound and the chain bound: the chain probe's time (one
    thread running the scan's per-pixel chain, in registers, once a pixel)."""
    cases = [("frame", density)] + [(n, torch.from_numpy(d).to(dev))
                                    for n, d in floyd_steinberg_cases(np.random.default_rng(1))]
    for name, d in cases:
        got = FSK.floyd_steinberg(d).cpu().numpy()
        want = FSK.floyd_steinberg_plain(d.cpu().numpy()).astype(np.float32)
        check(np.array_equal(got, want), f"floyd_steinberg kernel differs from the host scan at {name}")
    h, w = density.shape
    n_seeds = int(FSK.floyd_steinberg(density).shape[0])
    host = density.cpu().numpy()
    n_bytes = h * w * 4 + n_seeds * 8 + 4
    w0 = time.perf_counter()
    FSK.floyd_steinberg_plain(host)
    plain_ms = (time.perf_counter() - w0) * 1e3
    ms = cuda_ms(lambda: FSK.floyd_steinberg(density), reps=5)
    chain_ms = cuda_ms(lambda: FSK.chain_probe(h * w, dev), reps=5)
    return {"max_abs_err": 0.0, "shape": [h, w], "seeds": n_seeds, "edge_cases": [c[0] for c in cases[1:]],
            "ms": ms, "plain_ms": plain_ms, "plain_where": "host (numpy scan of the density read back)",
            "library_ms": None, "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "chain_bound_ms": chain_ms, "ms_over_chain_bound": ms / chain_ms,
            "chain_ns_per_pixel": chain_ms * 1e6 / (h * w), "sm_clock_after": sm_clock_mhz()}


def seg_stage_ms(rgb, depth, K, masks, model_points, dev) -> dict:
    """Stage times of one frame on the card, medians of ``SEG_REPS``: pixel
    stage, seeds (with the count's readback) and ALIC by CUDA events; the
    grouping (host, with its readbacks) and each registration by the host
    clock."""
    cfg = seg_config(K)
    rgb_t, depth_t = seg_frame_tensors(rgb, depth, dev)
    runs = []
    for _ in range(SEG_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        px = seg_pixel_stage(rgb_t, depth_t, cfg)
        ev[1].record()
        seeds = seg_seeds(px["density"])
        ev[2].record()
        n = seeds.shape[0]
        s_pad = -(-n // SEG_SEED_PAD) * SEG_SEED_PAD
        seed_xy = torch.zeros((s_pad, 2), dtype=torch.float32, device=dev)
        seed_xy[:n] = seeds
        indices, sp = seg_alic(px, seed_xy, torch.arange(s_pad, device=dev) < n, cfg, s_pad)
        ev[3].record()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        segments = seg_convex_grouping(indices.cpu().numpy(), *(np.ascontiguousarray(sp[k].cpu().numpy())
                                                                for k in ("world", "normal", "num")), cfg)
        group_ms = (time.perf_counter() - w0) * 1e3
        world = px["world"].cpu().numpy()
        reg_ms = []
        for mask, pts in zip(masks, model_points):
            w0 = time.perf_counter()
            seg_registrations(world, segments, [mask], [pts], dev)  # reads its scores back
            reg_ms.append((time.perf_counter() - w0) * 1e3)
        runs.append({"pixel_stage": ev[0].elapsed_time(ev[1]), "seeds": ev[1].elapsed_time(ev[2]),
                     "alic": ev[2].elapsed_time(ev[3]), "grouping_host": group_ms, "registrations": reg_ms})
    med = {k: statistics.median(r[k] for r in runs) for k in ("pixel_stage", "seeds", "alic", "grouping_host")}
    med["registration_each"] = [statistics.median(r["registrations"][i] for r in runs) for i in range(len(masks))]
    med["registration_total"] = sum(med["registration_each"])
    return med


def phase_seg(dev) -> tuple:
    """The bin-picking frame at full width on the card: ``convex_cloud_seg``,
    then ``pose_estimation`` of each object's covering segment, with the
    kernels' launch counts set to 0 just before and read just after; every
    stage against the port's CPU run (a spawned worker) to the bit; the two
    kernels against their plain versions; stage times; device-to-host
    reads per frame.  Prints ``{"seg": ...}``."""
    t0 = time.perf_counter()
    sc = synthetic.bin_picking_scene(SEG_IM, SEG_FOCAL, device=dev)
    rgb, depth, K, masks, pts = sc["rgb"], sc["depth"], sc["K"], sc["masks"], sc["model_points"]
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(SEG_CPU_THREADS,))
    try:
        cpu_run = pool.submit(seg_outputs, rgb, depth, K, masks, pts, "cpu")
        card = seg_outputs(rgb, depth, K, masks, pts, dev)  # also the warm-up of the main path
        torch.cuda.synchronize()
        # The main path, through the entry points a user calls.
        LR.similarity_local_sparse_cuda.launches = 0
        SS.segment_sum.launches = 0
        FSK.floyd_steinberg.launches = 0
        w0 = time.perf_counter()
        segments, world, normal = seg_convex_cloud_seg(rgb, depth, K, device=dev)
        regs = seg_registrations(world, segments, masks, pts, dev)
        frame_s = time.perf_counter() - w0
        launches = {"local_refine": LR.similarity_local_sparse_cuda.launches, "segment_sum": SS.segment_sum.launches,
                    "floyd_steinberg": FSK.floyd_steinberg.launches}
        check(launches["local_refine"] == 0, f"the seg path launched the refine kernel {launches['local_refine']} times")
        check(launches["segment_sum"] > 0 and launches["floyd_steinberg"] > 0, f"a seg kernel was not launched: {launches}")
        check(np.array_equal(card["segments"], segments), "convex_cloud_seg differs from its stages on the card")
        check(same_registrations(card["registrations"], regs), "registrations differ between two card runs")
        syncs = count_syncs(lambda: seg_registrations(world, seg_convex_cloud_seg(rgb, depth, K, device=dev)[0],
                                                      masks, pts, dev))
        cpu = cpu_run.result()
    finally:
        pool.shutdown(cancel_futures=True)
    for k in card["px"]:
        check(np.array_equal(card["px"][k], cpu["px"][k]), f"pixel stage {k} on the card differs from the CPU")
    check(np.array_equal(card["seeds"], cpu["seeds"]), "seeds on the card differ from the CPU")
    check(np.array_equal(card["indices"], cpu["indices"]), "ALIC indices on the card differ from the CPU")
    for k in card["sp"]:
        check(np.array_equal(card["sp"][k], cpu["sp"][k]), f"superpixel {k} on the card differs from the CPU")
    check(np.array_equal(card["segments"], cpu["segments"]), "segments on the card differ from the CPU")
    check(same_registrations(card["registrations"], cpu["registrations"]), "registrations on the card differ from the CPU")

    # The kernels at the main path's inputs, and at random shapes.
    cfg = seg_config(K)
    rgb_t, depth_t = seg_frame_tensors(rgb, depth, dev)
    px = seg_pixel_stage(rgb_t, depth_t, cfg)
    ids = torch.from_numpy(card["indices"].reshape(-1)).to(dev, torch.int64)  # int64, as the ALIC update gives them
    s_pad = int(card["sp"]["num"].shape[0])
    kernels = {"segment_sum": segment_sum_checks(dev, seg_alic_pixel_table(px), ids, s_pad),
               "floyd_steinberg": floyd_steinberg_checks(dev, px["density"])}
    stages = seg_stage_ms(rgb, depth, K, masks, pts, dev)
    models = TB.make_models()
    accepted = []
    for i, (s, n, T, lcp) in enumerate(regs):
        if lcp > 0.5:
            mesh = models[sc["obj_ids"][i]]
            accepted.append({"object": sc["obj_ids"][i], "lcp": lcp,
                             "adi_mm": pose_error.adi(T[:3, :3], T[:3, 3:], sc["R"][i], sc["t"][i].reshape(3, 1),
                                                      mesh, device=dev),
                             "diameter_mm": model_diameter(mesh["pts"])})
    line = {
        "frame": {"im": list(SEG_IM), "focal": SEG_FOCAL, "objects": sc["obj_ids"],
                  "visible_px": [int(m.sum()) for m in masks]},
        "seeds": int(len(card["seeds"])), "superpixels_padded": s_pad,
        "largest_superpixel_px": int(card["sp"]["num"].max()), "segments": int(segments.max() + 1),
        "registrations": [{"object": o, "segment": r[0], "points": r[1], "lcp": r[3]}
                          for o, r in zip(sc["obj_ids"], regs)],
        "accepted": len(accepted), "accepted_adi": accepted,
        "frame_s_host": frame_s, "stage_ms": stages, "device_to_host_reads_per_frame": syncs,
        "launches": launches, "kernels": kernels,
        "card_equals_cpu": True,
    }
    print(json.dumps({"seg": line}), flush=True)
    emit("seg", t0, **line)
    return launches, kernels


def phase_seg_golden(dev) -> dict:
    """The card against the JAX golden of ``tools/torch_port_seg_golden.py``
    (the bin-picking frame at 320 x 240): seeds, ALIC indices and means,
    segments to the bit (superpixel normals within 1e-6: the pixel normals
    are not JAX's bits), ALIC from JAX's pixel normals to the bit, and every
    registration's lcp and accept decision, R within 1e-5, t within 1e-3 mm."""
    g = dict(np.load(os.path.join(TESTDATA, "seg_golden.npz")))
    cfg = seg_config(g["K"])
    px, seeds, indices, sp = superpixel_stage(g["rgb"], g["depth"], cfg, int(g["seed_pad"]), dev)
    check(np.array_equal(seeds.cpu().numpy(), g["seeds"]), "golden seeds differ on the card")
    check(np.array_equal(indices.cpu().numpy(), g["indices"].astype(np.int32)), "golden ALIC indices differ on the card")
    sp = {k: np.ascontiguousarray(v.cpu().numpy()) for k, v in sp.items()}
    for k in sp:
        if k == "normal":
            check(np.abs(sp[k] - g["sp_normal"]).max() <= 1e-6, "golden superpixel normals differ on the card")
        else:
            check(np.array_equal(sp[k], g[f"sp_{k}"]), f"golden superpixel {k} differs on the card")
    segments = seg_convex_grouping(indices.cpu().numpy(), sp["world"], sp["normal"], sp["num"], cfg)
    check(np.array_equal(segments, g["segments"].astype(np.int64)), "golden segments differ on the card")
    n = len(g["seeds"])
    s_pad = -(-n // int(g["seed_pad"])) * int(g["seed_pad"])
    seed_xy = torch.zeros((s_pad, 2), dtype=torch.float32, device=dev)
    seed_xy[:n] = torch.from_numpy(g["seeds"]).to(dev)
    idx_j, sp_j = seg_alic(dict(px, normal=torch.from_numpy(g["px_normal"]).to(dev)), seed_xy,
                           torch.arange(s_pad, device=dev) < n, cfg, s_pad)
    check(np.array_equal(idx_j.cpu().numpy(), g["indices"].astype(np.int32)), "golden ALIC from JAX's normals differs")
    for k in sp_j:
        check(np.array_equal(sp_j[k].cpu().numpy(), g[f"sp_{k}"]), f"golden superpixel {k} from JAX's normals differs")
    models = TB.make_models()
    world = px["world"].cpu().numpy()
    worst = {"R": 0.0, "t_mm": 0.0}
    for i, obj in enumerate(g["obj_ids"]):
        s = int(g["reg_segment"][i])
        cloud = world[segments == s] * 1000.0
        check(len(cloud) == int(g["reg_points"][i]), f"golden segment of {obj} has {len(cloud)} points")
        T, lcp = seg_pose_estimation(cloud, synthetic.mesh_surface_points(models[str(obj)], seed=i), device=dev)
        want = float(g["reg_lcp"][i])
        check(lcp == want and (lcp > 0.5) == (want > 0.5), f"golden registration of {obj}: lcp {lcp}, JAX {want}")
        worst["R"] = max(worst["R"], float(np.abs(T[:3, :3] - g["reg_T"][i][:3, :3]).max()))
        worst["t_mm"] = max(worst["t_mm"], float(np.abs(T[:3, 3] - g["reg_T"][i][:3, 3]).max()))
    check(worst["R"] <= 1e-5 and worst["t_mm"] <= 1e-3, f"golden registrations beyond tolerance: {worst}")
    return {"seeds": n, "segments": int(segments.max() + 1), "registrations": len(g["obj_ids"]),
            "accepted": int((g["reg_lcp"] > 0.5).sum()), "worst_vs_jax": worst}


# -- multi-device matching (parallel/) -------------------------------------------

PARALLEL_REPS = 10
PARALLEL_TIMEOUT = 300.0  # seconds for each spawn of ranks; a rank that fails or hangs fails the phase
PARALLEL_CPU_THREADS = 2  # four CPU ranks on the machine's eight cores
PARALLEL_PROFILE = 1  # steps rank 0 profiles for its device time
SCALING_ITERS = 20
FUSED_KINDS = ("fused_mc", "fused_ms")  # held against the single-process pipeline on the card, not CPU ranks
FRAME_SEEDS = (1, 2, 3)  # the fused jobs' frames beyond each workload's own
ICP_PLANE_M = 0.9  # the bench frame's plane: where detect_icp starts every candidate


def workload_batch(w, draw):
    """(rgb, depth), each (4, ...): the workload's frame and three drawn as
    it draws its frame, from ``FRAME_SEEDS``."""
    frames = [(w["rgb"], w["depth"])] + [draw(seed) for seed in FRAME_SEEDS]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def fused_parallel_jobs(cid, det, frames, depths, w_mc, w_ms, reps: int) -> list:
    """The data-parallel fused jobs at full width, all at LOW_THRESHOLD:
    ``detect_icp`` at data 2 x template 2 on the bench batch (bench.py's
    refine stage: its first 512-point cloud, 16 ICP iterations, every
    candidate from the bench plane), ``fused_mc`` at data 4 on the
    multi-class workload (9 x 810 templates, 96 hypotheses x 4 seeds a
    class) and ``fused_ms`` at data 4 on the multi-scale workload (15 x 337
    templates, 5 proposals), each on four frames (``workload_batch``)."""
    b = synthetic.bench_refine_bank(det.bank.finalized(cid)[0].wh)
    init_T = np.tile(np.eye(4, dtype=np.float32), (BENCH_CFG.top_k, 1, 1))
    init_T[:, 2, 3] = ICP_PLANE_M
    rgb_mc, dep_mc = workload_batch(w_mc, synthetic.multiclass_frame)
    rgb_ms, dep_ms = workload_batch(w_ms, synthetic.multiscale_frame)
    common = dict(threshold=LOW_THRESHOLD, reps=reps)
    return [
        dict(kind="detect_icp", mesh=(2, 2, 1), levels=det.bank.finalized(cid), rgb=frames, depth=depths,
             cfg=BENCH_CFG, model_pts=b["fields"][0][0], K=b["K"], init_T=init_T, icp=b["icp"], **common),
        dict(kind="fused_mc", mesh=(4, 1, 1), class_ids=w_mc["class_ids"], templates=w_mc["templates"],
             infos=w_mc["infos"], K=w_mc["K"], pipeline=synthetic.multiclass_pipeline_args(w_mc), rgb=rgb_mc,
             depth=dep_mc, cfg=w_mc["cfg"], **common),
        dict(kind="fused_ms", mesh=(4, 1, 1), class_ids=w_ms["class_ids"], templates=w_ms["templates"],
             train_depth=w_ms["train_depth"], num_scales=w_ms["num_scales"], rgb=rgb_ms, depth=dep_ms,
             cfg=w_ms["cfg"], **common),
    ]


def fused_reference(job, pipe, ms_card) -> list:
    """The single-process card pipeline on each of a fused job's frames:
    ``FusedMultiClassPipeline`` or ``MultiScaleMultiClass``, as numpy."""
    run = pipe if job["kind"] == "fused_mc" else ms_card.match_arrays
    return [[a.cpu().numpy() for a in run(rgb, dep, job["threshold"])] for rgb, dep in zip(job["rgb"], job["depth"])]


def parallel_jobs(cid, det, frames, depths, w_ms, reps: int, checkpoint: str) -> list:
    """The jobs of the four ranks: data 2 x template 2 on the bench batch,
    tile 2 on its first frame, template 2 multi-scale on the first class of
    the multi-scale workload (337 templates), data 2 x template 2 on the
    bench batch again with each rank's shard restored from the bank's
    ``checkpoint`` (the mesh shape of the first job), and the dense-kernel
    route (the bench bank without feature lists) at data 2 x template 2 and
    tile 2 as the first two jobs, all at LOW_THRESHOLD."""
    levels = det.bank.finalized(cid)
    dense = without_features(levels)
    arrays = multiscale_class_arrays(w_ms["templates"][0], w_ms["train_depth"], w_ms["cfg"].t_at_level[-1])
    common = dict(threshold=LOW_THRESHOLD, reps=reps)
    return [
        dict(kind="sharded", mesh=(2, 2, 1), levels=levels, rgb=frames, depth=depths, cfg=BENCH_CFG, **common),
        dict(kind="tiled", mesh=(1, 1, 2), levels=levels, rgb=frames[0], depth=depths[0], cfg=BENCH_CFG, **common),
        dict(kind="multiscale", mesh=(1, 2, 1), arrays=arrays, rgb=w_ms["rgb"], depth=w_ms["depth"], cfg=w_ms["cfg"],
             train_depth=w_ms["train_depth"], num_scales=w_ms["num_scales"], **common),
        dict(kind="sharded", mesh=(2, 2, 1), checkpoint=checkpoint, class_id=cid, rgb=frames, depth=depths,
             cfg=BENCH_CFG, **common),
        dict(kind="sharded", mesh=(2, 2, 1), levels=dense, rgb=frames, depth=depths, cfg=BENCH_CFG, **common),
        dict(kind="tiled", mesh=(1, 1, 2), levels=dense, rgb=frames[0], depth=depths[0], cfg=BENCH_CFG, **common),
    ]


def dense_job(job) -> bool:
    """A job on the dense-kernel route: its bank has no feature lists."""
    return "levels" in job and job["levels"][0].feats is None


def mesh_in_one_process(job, dev) -> list:
    """A ``sharded`` or ``tiled`` job computed in this one process on the
    card, step for step as its ranks compute it but with no collective: per
    template shard (``shard_bank``) the frames' candidates, merged by
    ``merge_topk`` and then box NMS, as ``detect_shard`` merges the gathered
    shards; or per row slab its window of ``required_halo`` rows each side
    cut from the whole frame (zero rows past the frame), the candidates whose
    rows the slab owns and ``merge_topk``, as ``tiled_detect`` merges them.
    Returns the job's outputs as numpy, in the full batch's layout."""
    cfg, thr = job["cfg"], job["threshold"]
    rgb = torch.from_numpy(np.ascontiguousarray(job["rgb"])).to(dev)
    dep = torch.from_numpy(job["depth"].astype(np.int32)).to(dev)
    if job["kind"] == "sharded":
        n_t = job["mesh"][1]
        parts = []
        for s in range(n_t):
            bank = shard_bank(job["levels"], n_t, s, dev)
            tid, x, y, score, _ = detect_frame_core(rgb, dep, bank, cfg, thr, apply_nms=False)
            wh = bank.whs[0][tid.long()]
            fields = [tid + s * bank.nfeats[0].shape[0], x, y, score, wh[..., 0], wh[..., 1]]
            parts.append(torch.stack([f.to(torch.float64) for f in fields], dim=-2))
        merged = merge_topk(torch.stack(parts, dim=1), cfg.top_k)  # (B, 6, K)
        mtid, mx, my, mw, mh = (merged[:, i].to(torch.int32) for i in (0, 1, 2, 4, 5))
        mscore = merged[:, 3].to(torch.float32)
        keep = nms_boxes(torch.stack([mx, my, mw, mh], dim=-1).to(torch.float32), mscore, cfg.nms_iou)
        return [a.cpu().numpy() for a in (mtid, mx, my, mscore, keep)]
    n = job["mesh"][2]
    slab = rgb.shape[0] // n
    bank = bank_levels_from_numpy(job["levels"], dev)
    halo = min(required_halo(cfg, bank.kdims[0][0]), slab * (n - 1))
    rgb_p = torch.nn.functional.pad(rgb, (0, 0, 0, 0, halo, halo))
    dep_p = torch.nn.functional.pad(dep, (0, 0, halo, halo))
    parts = []
    for i in range(n):
        rows = slice(i * slab, (i + 1) * slab + 2 * halo)
        tid, x, y, score, _ = detect_frame_core(rgb_p[rows], dep_p[rows], bank, cfg, thr, apply_nms=False)
        own = (y >= halo) & (y < halo + slab) & (score >= 0)
        score = torch.where(own, score, torch.full_like(score, -1.0))
        parts.append(torch.stack([f.to(torch.float64) for f in (tid, x, y - halo + i * slab, score)]))
    merged = merge_topk(torch.stack(parts), cfg.top_k)
    return [merged[i].to(torch.int32).cpu().numpy() for i in range(3)] + [merged[3].to(torch.float32).cpu().numpy()]


def checkpoint_checks(job, card: list, cpu: list, i: int, levels) -> dict:
    """The checkpoint job ``i`` against the ``levels`` job 0 of the same
    mesh: every card and CPU rank's restored shard equal to ``shard_bank``
    of the levels to the bit, its outputs equal to job 0's, one refine
    launch a level in its first step.  Returns each card rank's restore
    seconds (its first import of ``torch.distributed.checkpoint`` apart) and
    bytes read beside its set-up seconds in job 0."""
    what = f"the checkpoint job (mesh {job['mesh']})"
    shards = job["mesh"][1]
    out = {"restore_s_by_rank": [], "restore_import_s_by_rank": [], "restore_bytes_by_rank": [],
           "levels_route_setup_s_by_rank": []}
    for r in range(4):
        for side, runs in (("card", card), ("CPU", cpu)):
            res = runs[r][i]
            want = shard_bank(levels, shards, res["coordinate"][1], "cpu")
            got = res["restore"]["levels"]
            check(all(lv.kernels is None and tuple(lv.kdims) == wd
                      and all(np.array_equal(a, b.numpy()) and a.dtype == b.numpy().dtype
                              for a, b in zip((lv.nfeat, lv.wh, lv.feats, lv.valid), (wn, ww, wf, wv)))
                      for lv, wd, wn, ww, wf, wv in zip(got, want.kdims, want.nfeats, want.whs, want.feats, want.valids)),
                  f"{what}: rank {r}'s restored shard on the {side} differs from the levels route's")
        check(all(np.array_equal(a, b) for a, b in zip(card[r][i]["outputs"], card[r][0]["outputs"])),
              f"{what}: rank {r}'s outputs differ from the levels route's")
        check(card[r][i]["launches"] == len(BENCH_CFG.t_at_level) - 1,
              f"{what}: rank {r} launched the refine kernel {card[r][i]['launches']} times in one step")
        out["restore_s_by_rank"].append(card[r][i]["restore"]["seconds"])
        out["restore_import_s_by_rank"].append(card[r][i]["restore"]["import_s"])
        out["restore_bytes_by_rank"].append(card[r][i]["restore"]["bytes_read"])
        out["levels_route_setup_s_by_rank"].append(card[r][0]["setup_s"])
    out["equals"] = "the levels route's shards and outputs on every rank (bitwise)"
    return out


def phase_parallel(dev, cid, det, frames, depths, w_ms, w_mc, pipe, ms_card) -> dict:
    """The ``parallel`` entry points at full width, each rank a spawned
    process (``run_ranks``, joined under ``PARALLEL_TIMEOUT``):

    - mesh (1, 1, 1), one rank over NCCL: ``sharded_detect`` on the bench
      batch (B = 4) equal to ``Detector.match_batch_arrays`` on the card;
    - four ranks sharing the card over gloo: ``sharded_detect`` at data 2 x
      template 2 (B = 4), ``tiled_detect`` at tile 2 (one frame),
      ``sharded_multiscale_detect`` at template 2 (one frame, 337
      templates) and ``sharded_detect_refine`` at data 2 x template 2
      (B = 4, 128 candidates a frame through ICP), each equal to the same
      mesh in four CPU ranks: the same ranks answer on both sides, and
      exactly the mesh's ranks answer; in the same spawn the dense-kernel
      route (the bench bank without feature lists) at data 2 x template 2
      and tile 2, each also equal to the same mesh computed in one process
      on the card (``mesh_in_one_process``) in every slot;
    - in a second spawn of the four ranks, beside ``detect_icp``,
      ``fused_multiclass_over_data`` and ``multiscale_multiclass_over_data``
      at data 4 (B = 4, one frame a rank), every rank's full batch equal
      frame by frame to the
      single-process ``pipe`` and ``ms_card`` on the card, to the bit, and
      the fused frame's inactive hypotheses at -1 in fitness and verify.

    Each rank sets its local-refine launch count to 0 just before its job's
    first step and reads it just after; every card rank of every mesh must
    have launched the kernel, and none of a dense-kernel route's mesh.  Rank 0 times each step and its merge
    collective alone with CUDA events, then profiles ``PARALLEL_PROFILE``
    steps for its own device time (the rest of the step is the rank's host
    work and waits); each card rank reports its peak of allocated device
    memory in the job.  The rows of ranks sharing the card carry no
    efficiency."""
    t0 = time.perf_counter()
    levels = det.bank.finalized(cid)
    single = [dict(kind="sharded", mesh=(1, 1, 1), levels=levels, rgb=frames, depth=depths, cfg=BENCH_CFG,
                   threshold=LOW_THRESHOLD, reps=PARALLEL_REPS, profile=PARALLEL_PROFILE)]
    (nccl,) = run_ranks(run_jobs, 1, ("cuda", single), device_type="cuda", timeout=PARALLEL_TIMEOUT)[0]
    ref = tuple(a.cpu().numpy() for a in det.match_batch_arrays(frames, depths, LOW_THRESHOLD, cid))
    check(all(np.array_equal(a, b) for a, b in zip(nccl["outputs"], ref)),
          "the (1, 1, 1) NCCL mesh differs from Detector.match_batch_arrays")
    check(nccl["launches"] > 0, "the (1, 1, 1) mesh did not launch the refine kernel")
    meshes = [{"mesh": [1, 1, 1], "kind": "sharded", "backend": backend_for("cuda", 1), "ranks": 1, "frames": 4,
               "shared_card": False, "equals": "Detector.match_batch_arrays on the card", "launches_by_rank": [nccl["launches"]],
               "ms": nccl["ms"], "merge_ms": nccl["merge_ms"], "rank0_profile": nccl["profile"],
               "peak_mib_by_rank": [nccl["peak_bytes"] / 2**20]}]

    ckpt = tempfile.TemporaryDirectory(prefix="bench_bank_checkpoint_")  # removed when the phase returns
    s0 = time.perf_counter()
    det.bank.save_checkpoint(ckpt.name)
    ckpt_save_s = time.perf_counter() - s0
    matching = parallel_jobs(cid, det, frames, depths, w_ms, PARALLEL_REPS, ckpt.name)
    fused = fused_parallel_jobs(cid, det, frames, depths, w_mc, w_ms, PARALLEL_REPS)
    jobs = matching + fused
    backend = backend_for("cuda", 4)  # gloo on one card; NCCL where each rank has a card of its own
    s0 = time.perf_counter()
    # Two spawns of three meshes each: over NCCL on four cards, ranks holding
    # six meshes' communicators hung in their teardown.
    card = [a + b for a, b in zip(*(
        run_ranks(run_jobs, 4, ("cuda", [j if "checkpoint" in j else dict(j, profile=PARALLEL_PROFILE) for j in part]),
                  device_type="cuda",
                  timeout=PARALLEL_TIMEOUT) for part in (matching, fused)))]
    card_s = time.perf_counter() - s0
    on_cpu = [i for i, j in enumerate(jobs) if j["kind"] not in FUSED_KINDS]
    s0 = time.perf_counter()
    cpu_runs = run_ranks(run_jobs, 4, ("cpu", [dict(jobs[i], reps=0) for i in on_cpu]), device_type="cpu",
                         timeout=PARALLEL_TIMEOUT, threads=PARALLEL_CPU_THREADS)
    cpu_s = time.perf_counter() - s0
    cpu = [{i: r[n] for n, i in enumerate(on_cpu)} for r in cpu_runs]
    for i, job in enumerate(jobs):
        what = f"{job['kind']} mesh {job['mesh']}"
        ranks = [r for r in range(4) if card[r][i] is not None]
        check(len(ranks) == int(np.prod(job["mesh"])), f"{what}: {len(ranks)} card ranks answered")
        dense = dense_job(job)
        for r in ranks:
            if dense:
                check(card[r][i]["launches"] == 0, f"{what} without feature lists: rank {r} launched the refine "
                                                   f"kernel {card[r][i]['launches']} times")
            else:
                check(card[r][i]["launches"] > 0, f"{what}: rank {r} launched no refine kernel")
        if job["kind"] in FUSED_KINDS:
            s0 = time.perf_counter()
            want = fused_reference(job, pipe, ms_card)
            ref_s = time.perf_counter() - s0
            for r in ranks:
                got = card[r][i]["outputs"]
                for f, frame in enumerate(want):
                    check(all(np.array_equal(a[f], b) for a, b in zip(got, frame)),
                          f"{what}: rank {r}'s frame {f} differs from the single-process card pipeline")
            out = card[0][i]["outputs"]
            equals = "the single-process card pipeline, frame by frame (bitwise)"
            if job["kind"] == "fused_mc":
                inactive = ~out[8]
                check(bool((out[6][inactive] == -1).all() and (out[7][inactive] == -1).all()),
                      f"{what}: an inactive hypothesis does not read -1")
                extra = {"active": int(out[8].sum()), "hypotheses": int(out[8].size),
                         "icp_candidates_per_frame": int(out[8][0].size) * job["pipeline"]["icp_seeds"]}
            else:
                extra = {"live_candidates": int((out[3] >= 0).sum())}
            extra.update(reference_seconds=ref_s, job_pickle_mib=len(pickle.dumps(job)) / 2**20)
        else:
            check(all((card[r][i] is None) == (cpu[r][i] is None) for r in range(4)),
                  f"{what}: the card and CPU runs answered from different ranks")
            for r in ranks:
                check(all(np.array_equal(a, b) for a, b in zip(card[r][i]["outputs"], cpu[r][i]["outputs"])),
                      f"{what}: rank {r} on the card differs from the CPU ranks")
            out = card[0][i]["outputs"]
            equals = "the same mesh in CPU ranks (gloo)"
            extra = {"live_candidates": int((out[3] >= 0).sum())}
            if dense:
                s0 = time.perf_counter()
                one = mesh_in_one_process(job, dev)
                check(all(np.array_equal(a, b) for a, b in zip(out, one)),
                      f"{what} without feature lists differs from the same mesh computed in one process")
                sparse = next(k for k, j in enumerate(jobs) if j["kind"] == job["kind"] and j["mesh"] == job["mesh"])
                with_keep = lambda o: list(o) if len(o) == 5 else list(o) + [o[3] >= 0]  # noqa: E731 (tiled: no keep)
                same = same_live(with_keep(out), with_keep(card[0][sparse]["outputs"]))
                equals = ("the same mesh in CPU ranks (gloo) and in one process on the card, every slot (bitwise); "
                          "route: dense kernels, grouped-conv refinement")
                extra.update(route="dense", equals_sparse_route_live=bool(same), one_process_s=time.perf_counter() - s0)
            if job["kind"] == "detect_icp":
                extra.update(icp_candidates_per_frame=int(out[5].shape[1]), fitness_mean=float(out[6].mean()))
            if "checkpoint" in job:
                extra.update(checkpoint_checks(job, card, cpu, i, levels), checkpoint_save_s=ckpt_save_s)
        prof = card[0][i].get("profile")  # the checkpoint job is not profiled: job 0 of its mesh is
        meshes.append({
            "mesh": list(job["mesh"]), "kind": job["kind"], "backend": backend, "ranks": len(ranks),
            "frames": len(job["rgb"]) if job["kind"] not in ("tiled", "multiscale") else 1,
            "shared_card": backend == "gloo", "equals": equals,
            "launches_by_rank": [card[r][i]["launches"] for r in ranks], "ms": card[0][i]["ms"],
            "merge_ms": card[0][i]["merge_ms"], "rank0_profile": prof,
            "rank0_idle_share": 1.0 - prof["device_ms"] / prof["wall_ms"] if prof else None,
            "peak_mib_by_rank": [card[r][i]["peak_bytes"] / 2**20 for r in ranks],
            "rank0_setup_s": card[0][i]["setup_s"], "rank0_first_step_s": card[0][i]["first_step_s"],
            "rank0_job_s": card[0][i]["job_s"], **extra,
        })
    ckpt.cleanup()
    launches = sum(sum(m["launches_by_rank"]) for m in meshes)
    emit("parallel", t0, meshes=meshes, launches=launches, reps=PARALLEL_REPS, threshold=LOW_THRESHOLD,
         card_spawn_seconds=card_s, cpu_spawn_seconds=cpu_s,
         note="ms: CUDA events on rank 0 per step; merge_ms: the merge's all_gather alone (over data for "
              "detect_icp, fused_mc and fused_ms); rank0_profile: rank 0's own kernel time, profiled wall time and "
              "kernels per step under torch.profiler; peak_mib_by_rank: torch.cuda.max_memory_allocated in the job; "
              "ranks sharing one card share its time, so their rows carry no efficiency")
    return {"launches": launches, "meshes": meshes}


# -- the SIXD tool twins (tools/) -------------------------------------------------

TOOLS_IM = (240, 180)
TOOLS_K = np.array([[240.0, 0, 120.0], [0, 240.0, 90.0], [0, 0, 1.0]])
TOOLS_RADIUS = 430.0
TOOLS_VIEWS = 60
TOOLS_CPU_THREADS = 6


def tools_scene():
    """Two views of the textured box at known poses (the mini-SIXD scene of
    tests/test_tools.py), rendered on the CPU: [(rgb, depth, gt)]."""
    model = TB.make_models()["texbox"]
    views, _ = sample_views(8, radius=TOOLS_RADIUS, elev_range=(0.3, 1.2), tilt_range=(0, 0.1), tilt_step=1.0)
    out = []
    for view in views[:2]:
        t = view["t"] + np.array([[10.0], [-5.0], [15.0]])
        rgb, depth = GR.render(model, TOOLS_IM, TOOLS_K, view["R"], t, mode="rgb+depth", texture=model["texture"],
                               device="cpu")
        out.append((rgb.numpy(), depth.numpy().astype(np.uint16), {"obj_id": 1, "cam_R_m2c": view["R"], "cam_t_m2c": t}))
    return out


def tools_chain(device, scene) -> dict:
    """The twins' compute on ``device``: ``train_object`` (the textured box,
    ``TOOLS_VIEWS`` views, 24 features), the bank through its npz and
    ``DetectorConfig()`` as ``detect_sixd`` reads it, ``detect_image`` on
    each view, ``image_errors`` (ADI) and ``localization_scores``."""
    model = TB.make_models()["texbox"]
    LR.similarity_local_sparse_cuda.launches = 0
    det, stats = tools_train.train_object(model, TOOLS_K, "obj_01", [TOOLS_RADIUS], TOOLS_VIEWS, TOOLS_IM,
                                          tools_train.detector_config(24), device)
    with tempfile.TemporaryDirectory() as tmp:
        det.write_classes(os.path.join(tmp, "obj_01.npz"))
        det = Detector.read_classes(os.path.join(tmp, "obj_01.npz"), DetectorConfig(), device=device)
    results, errors = [], []
    for im_id, (rgb, depth, gt) in enumerate(scene):
        res, _ = tools_detect.detect_image(det, model, rgb, depth, TOOLS_K, 60.0, 8, device)
        results.append(res["ests"])
        errors += tools_errors.image_errors(im_id, 1, res["ests"], [gt], model, None, TOOLS_K, "adi", device=device)
    gts = {im_id: [gt] for im_id, (_, _, gt) in enumerate(scene)}
    scores = tools_loc.localization_scores([(1, errors, gts, {})], "adi", {1: model_diameter(model["pts"])})
    return {"stats": stats, "templates": [[(lv.features, lv.width, lv.height) for lv in t]
                                          for t in det.bank.templates["obj_01"]],
            "ests": results, "errors": errors, "recall": scores["all"]["total_recall"],
            "launches": LR.similarity_local_sparse_cuda.launches}


def png_bytes(im: np.ndarray):
    """``im`` encoded as ``inout.save_im`` writes it, or None without PIL."""
    try:
        from PIL import Image
    except ImportError:
        return None
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="png")
    return buf.getvalue()


def vis_overlays(dev, scene, ests) -> dict:
    """``vis_poses.overlay`` of each view's ground truth and of the CPU
    chain's estimates on the card and on the CPU: equal images, and equal
    PNG bytes where PIL is present."""
    models = {1: TB.make_models()["texbox"]}
    poses = [[(1, gt["cam_R_m2c"], gt["cam_t_m2c"])] for _, _, gt in scene]
    poses += [[(1, e["R"], e["t"]) for e in view_ests] for view_ests in ests]
    images = [rgb for rgb, _, _ in scene] * 2
    card = [tools_vis.overlay(rgb, p, models, TOOLS_K, 0.5, dev) for rgb, p in zip(images, poses)]
    cpu = [tools_vis.overlay(rgb, p, models, TOOLS_K, 0.5, "cpu") for rgb, p in zip(images, poses)]
    check(all(np.array_equal(a, b) for a, b in zip(card, cpu)), "vis_poses' overlays on the card differ from the CPU's")
    drawn = [int((a != rgb).any(axis=-1).sum()) for a, rgb in zip(card, images)]
    check(min(drawn) > 500, f"vis_poses drew no silhouette: {drawn} pixels changed")
    pngs = [(png_bytes(a), png_bytes(b)) for a, b in zip(card, cpu)]
    same_png = None if pngs[0][0] is None else all(a == b for a, b in pngs)
    check(same_png is not False, "vis_poses' PNGs on the card differ from the CPU's")
    return {"overlays": len(card), "gt_and_estimates": True, "pixels_drawn": drawn, "card_equals_cpu": True,
            "png_bytes_equal": same_png}


def phase_tools(dev) -> dict:
    """The tool twins' compute on the card against the port's CPU run (a
    spawned worker): the same templates, estimates within ``FUSED_TOL``
    (scores exactly), ADI errors within its t tolerance, the same recall;
    the refine kernel's launches (set to 0 just before, read just after)."""
    t0 = time.perf_counter()
    scene = tools_scene()
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(TOOLS_CPU_THREADS,))
    try:
        cpu_run = pool.submit(tools_chain, "cpu", scene)
        w0 = time.perf_counter()
        card = tools_chain(dev, scene)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - w0
        cpu = cpu_run.result(timeout=PARALLEL_TIMEOUT)
    finally:
        pool.shutdown(cancel_futures=True)
    same_templates = len(card["templates"]) == len(cpu["templates"]) and all(
        np.array_equal(fa, fb) and (wa, ha) == (wb, hb)
        for a, b in zip(card["templates"], cpu["templates"]) for (fa, wa, ha), (fb, wb, hb) in zip(a, b))
    check(same_templates and card["stats"] == cpu["stats"], f"training on the card differs: {card['stats']} {cpu['stats']}")
    est_diff = {"R": 0.0, "t_mm": 0.0}
    for ea, eb in zip(card["ests"], cpu["ests"]):
        check(len(ea) == len(eb) and [e["score"] for e in ea] == [e["score"] for e in eb],
              "the card's estimates differ from the CPU's in count or score")
        for a, b in zip(ea, eb):
            est_diff["R"] = max(est_diff["R"], float(np.abs(np.asarray(a["R"]) - np.asarray(b["R"])).max()))
            est_diff["t_mm"] = max(est_diff["t_mm"], float(np.abs(np.asarray(a["t"]) - np.asarray(b["t"])).max()))
    check(est_diff["R"] <= FUSED_TOL["R"] and est_diff["t_mm"] <= FUSED_TOL["t_mm"], f"estimates differ: {est_diff}")
    err_diff = max(abs(a["errors"][0] - b["errors"][0]) for a, b in zip(card["errors"], cpu["errors"]))
    check(len(card["errors"]) == len(cpu["errors"]) == len(scene) and err_diff <= FUSED_TOL["t_mm"],
          f"ADI errors differ by {err_diff} mm")
    check(card["recall"] == cpu["recall"], f"recall {card['recall']} on the card, {cpu['recall']} on the CPU")
    check(card["launches"] > 0, "the twins' detection did not launch the refine kernel")
    vis = vis_overlays(dev, scene, cpu["ests"])
    tless = check_poses_tless(dev, scene)
    twins = measurement_twins()
    emit("tools", t0, train=card["stats"], templates=len(card["templates"]), recall=card["recall"],
         adi_mm=[e["errors"][0] for e in card["errors"]], estimates_diff=est_diff, adi_diff_mm=err_diff,
         card_equals_cpu=True, launches=card["launches"], card_seconds=card_s, vis_poses=vis,
         check_poses_tless=tless, measurement_twins=twins)
    return {"launches": card["launches"], "recall": card["recall"]}


def tless_tree(root: str, scene) -> None:
    """A mini T-LESS tree of ``scene`` under ``root``: the textured box as
    ``models_cad/obj_01.ply`` and its views as ``test_primesense/01`` (RGB,
    depth in T-LESS's 0.1 mm units, info.yml, gt.yml with each view's box)."""
    from sixdpose_tpu_torch.data import inout

    os.makedirs(os.path.join(root, "models_cad"))
    inout.save_ply(os.path.join(root, "models_cad", "obj_01.ply"), TB.make_models()["texbox"])
    scene_dir = os.path.join(root, "test_primesense", "01")
    info, gts = {}, {}
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(scene_dir, sub))
    for im_id, (rgb, depth, gt) in enumerate(scene):
        inout.save_im(os.path.join(scene_dir, "rgb", f"{im_id:04d}.png"), rgb)
        inout.save_depth(os.path.join(scene_dir, "depth", f"{im_id:04d}.png"), depth.astype(np.uint16) * 10)
        x, y = np.nonzero(depth > 0)[::-1]
        info[im_id] = {"cam_K": TOOLS_K, "depth_scale": 0.1}
        gts[im_id] = [dict(gt, obj_bb=[int(x.min()), int(y.min()), int(x.max() - x.min()), int(y.max() - y.min())])]
    inout.save_info(os.path.join(scene_dir, "info.yml"), info)
    inout.save_gt(os.path.join(scene_dir, "gt.yml"), gts)


def check_poses_tless(dev, scene) -> dict:
    """The ``check_poses_tless`` twin through its ``main`` on a mini T-LESS
    tree of the tools' scene, its renders on the card and on the CPU: the
    same files, byte for byte, and an overlay drawn over each view."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "t-less_v2")
        tless_tree(root, scene)
        outs = {}
        for device in ("card", "cpu"):
            outs[device] = os.path.join(tmp, device)
            with contextlib.redirect_stdout(io.StringIO()):
                code = tools_tless.main(["--base-path", root, "--scenes", "1", "--im-step", "1", "--out",
                                         outs[device], "--torch-device", str(dev) if device == "card" else "cpu"])
            check(code == 0, f"check_poses_tless failed on {device}")
        names = sorted(os.listdir(outs["card"]))
        check(len(names) == 2 * len(scene) and names == sorted(os.listdir(outs["cpu"])),
              f"check_poses_tless wrote {names}")
        same = [open(os.path.join(outs["card"], n), "rb").read() == open(os.path.join(outs["cpu"], n), "rb").read()
                for n in names]
        check(all(same), f"check_poses_tless' PNGs on the card differ from the CPU's: {dict(zip(names, same))}")
        png_size = {n: os.path.getsize(os.path.join(outs["card"], n)) for n in names}
    drawn, models = [], {1: TB.make_models()["texbox"]}
    for rgb, depth, gt in scene:
        vis, ren = tools_tless.gt_overlay(rgb, [gt], models, TOOLS_K, device=dev)
        drawn.append(int((vis != rgb).any(axis=-1).sum()))
        check(np.array_equal(ren > 0, depth > 0), "check_poses_tless' render misses the view's own silhouette")
    check(min(drawn) > 500, f"check_poses_tless drew no overlay: {drawn} pixels changed")
    return {"files": names, "png_bytes": png_size, "card_equals_cpu_bytes": True, "pixels_drawn": drawn}


def measurement_twins() -> dict:
    """``bench_stage_breakdown`` and ``bench_local_refine`` through their
    ``main`` on the card at their defaults (their lines print here); the
    refine twin's kernel must equal its plain version exactly.  Returns
    their reports."""
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, tool in (("bench_stage_breakdown", tools_stages), ("bench_local_refine", tools_refine)):
            path = os.path.join(tmp, f"{name}.json")
            check(tool.main(["--out", path]) == 0, f"{name} failed")
            with open(path) as fh:
                reports[name] = json.load(fh)
    refine = reports["bench_local_refine"]
    check(refine["equivalent"] and refine["grouped_conv_equal"],
          "bench_local_refine: the kernel or the grouped conv differs from the plain version")
    check(all(np.isfinite(v) and v > 0 for v in reports["bench_stage_breakdown"]["prefix_ms"].values()),
          "bench_stage_breakdown: a prefix has no time")
    return reports


# -- bench.py's twin (python -m sixdpose_tpu_torch.bench) ------------------------

BENCH_BUDGET_S = 90  # SIXDPOSE_BENCH_BUDGET_S of the twin's run: its optional stages stop once it is spent


def phase_bench(dev, cid, det, det_cpu) -> int:
    """``python -m sixdpose_tpu_torch.bench`` on the card, in a process of
    its own with ``SIXDPOSE_BENCH_BUDGET_S`` at ``BENCH_BUDGET_S``: every
    line it prints is JSON and the last holds every fps key above 0, the
    card's name and power limit and the refine kernel's launches in its run
    (its counter starts at 0 in that process); its last record is
    re-emitted on the ``bench`` line.  Then the gate bench.py lacks on the
    synthetic bank, at bench.py's threshold (no match is live on this bank)
    and at ``LOW_THRESHOLD`` (every candidate is): the twin's one-frame
    chain on the card against the port's CPU ``detect_frame_core`` on the
    same frame, and one step of its batch chain at each B of its sweep on
    bench.py's batch frames (``stack([rgb] * B) ^ arange(B)``) on the card
    against the same step on the CPU, to the bit (the matches of every
    frame and the perturbed frames).  The CPU runs the kernel's plain
    version, so this holds the kernel against it at every shape the twin
    launches it.  Returns the twin's launches."""
    t0 = time.perf_counter()
    env = dict(os.environ, SIXDPOSE_BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    proc = subprocess.run([sys.executable, "-m", "sixdpose_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=BENCH_BUDGET_S + 300)
    check(proc.returncode == 0, f"the bench twin exited {proc.returncode}: {proc.stderr[-3000:]}")
    records = [json.loads(line) for line in proc.stdout.splitlines()]
    last = records[-1]
    check(all(last.get(k, 0) > 0 for k in TBN.RECORD_KEYS), f"the bench twin's record lacks a key: {last}")
    check(bool(last["nvidia_smi"]) and last["local_refine_launches"] > 0,
          f"the bench twin's record names no card or launched no refine kernel: {last}")
    twin_s = time.perf_counter() - t0

    _, _, rgb, dep = synthetic.bench_bank()
    rgb_c, dep_c = torch.from_numpy(rgb), torch.from_numpy(dep.astype(np.int32))
    bank, bank_cpu = det.device_bank(cid), det_cpu.device_bank(cid)
    gate = {}
    for thr in (TBN.THRESHOLD, LOW_THRESHOLD):
        r_card, m_card = TBN.match_chain(1, rgb_c.to(dev), dep_c.to(dev), bank, threshold=thr)
        m_cpu = detect_frame_core(rgb_c, dep_c, bank_cpu, BENCH_CFG, thr)
        r_cpu = rgb_c ^ (m_cpu[3][0] % 2.0).to(torch.uint8)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(m_card, m_cpu)) and torch.equal(r_card.cpu(), r_cpu)
        check(same, f"the bench twin's one-frame chain on the card differs from the port's CPU at {thr}")
        live = {"B1": int((m_cpu[3] >= 0).sum())}
        for b_n in TBN.BATCHES:
            rgb_b = torch.from_numpy(np.stack([rgb] * b_n) ^ np.arange(b_n, dtype=np.uint8)[:, None, None, None])
            dep_b = dep_c.expand(b_n, -1, -1).contiguous()
            r_card, m_card = TBN.batch_chain(1, rgb_b.to(dev), dep_b.to(dev), bank, threshold=thr)
            r_cpu, m_cpu = TBN.batch_chain(1, rgb_b, dep_b, bank_cpu, threshold=thr)
            same = all(torch.equal(a.cpu(), b) for a, b in zip(m_card, m_cpu)) and torch.equal(r_card.cpu(), r_cpu)
            check(same, f"the bench twin's B={b_n} batch step on the card differs from the port's CPU at {thr}")
            live[f"B{b_n}"] = int((m_cpu[3] >= 0).sum())
        gate[str(thr)] = live
    check(all(gate[str(LOW_THRESHOLD)].values()), f"no live match at {LOW_THRESHOLD}: {gate}")
    emit("bench", t0, record=last, lines=len(records), budget_s=BENCH_BUDGET_S, twin_seconds=twin_s,
         gate={"card_equals_cpu_bitwise": True, "batches": [1, *TBN.BATCHES], "live_matches_by_threshold": gate},
         note="fps by the slope of eager frame chains on the wall clock (best of 3 a length), host dispatch "
              "included; the timing phase's medians are CUDA events around single calls")
    return int(last["local_refine_launches"])


# -- the dense-kernel route (a bank without feature lists) ----------------------

DENSE_THRESHOLDS = (75.0, LOW_THRESHOLD)
DENSE_BATCHES = (1, 4)
DENSE_REPS = 10


@contextmanager
def recording_conv_calls(calls: list):
    """Record the inputs of every grouped-conv refinement
    (``similarity_local``) the main path makes, at the detector's dispatch."""
    original = D.similarity_local

    def recorder(maps, kernels, origins, t, window=16):
        calls.append(dict(maps=maps, kernels=kernels, origins=origins, t=t, window=window))
        return original(maps, kernels, origins, t, window)

    D.similarity_local = recorder
    try:
        yield
    finally:
        D.similarity_local = original


def peak_mib(fn) -> float:
    """Peak of allocated device memory during ``fn`` above what was
    allocated before it, MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def phase_dense_route(dev, cid, det, det_cpu, frames, depths) -> int:
    """The dense-kernel route: a bank passed without feature lists, scored by
    the dense conv and refined by the grouped conv of ``similarity_local``
    (the JAX package's route for such a bank, and its entry program's).  With
    the refine kernel's launch count set to 0 just before: ``entry()`` on
    the card, and the bench workload's bank without its lists
    (``DeviceBank.without_features``) through ``detect_frame_core`` at 75
    and LOW_THRESHOLD, one frame and the batch of 4; the count, and the
    coarse kernel's launches over the same calls, are read just after and
    must be 0, and every grouped-conv call is recorded.  Then
    ``entry()`` equal to the port's CPU run and to the JAX golden of
    ``tools/torch_port_entry_golden.py``, and each bench point equal to the
    port's CPU run in every slot, to the bit; beside it, whether its live
    slots (and keep) equal the sparse route's on the same bank with its
    lists (reported, not gated: the JAX package holds the route to itself).
    CUDA-event medians: ms per frame of both routes at B = 1 and 4, ms per
    grouped-conv call per level (``similarity_local`` whole, and the
    ``F.conv2d`` alone on its operands) at each recorded call at
    LOW_THRESHOLD, and the peak device memory per frame of both routes.
    Returns the launches (0)."""
    t0 = time.perf_counter()
    sparse = det.device_bank(cid)
    bank, bank_cpu = sparse.without_features(), det_cpu.device_bank(cid).without_features()
    rgb_t, dep_t = torch.from_numpy(frames).to(dev), torch.from_numpy(depths.astype(np.int32)).to(dev)
    inputs = {1: (rgb_t[0], dep_t[0]), 4: (rgb_t, dep_t)}
    points = [(thr, b) for thr in DENSE_THRESHOLDS for b in DENSE_BATCHES]
    calls: list = []
    LR.similarity_local_sparse_cuda.launches = 0
    coarse_before = CS.similarity_multiscale_cuda.launches
    with recording_conv_calls(calls):
        fn, args = port_entry(device=dev)
        card_entry = fn(*args)
        card = {p: detect_frame_core(*inputs[p[1]], bank, BENCH_CFG, p[0]) for p in points}
        torch.cuda.synchronize()
    launches = LR.similarity_local_sparse_cuda.launches
    check(launches == 0, f"the dense-kernel route launched the refine kernel {launches} times")
    coarse = CS.similarity_multiscale_cuda.launches - coarse_before
    check(coarse == 0, f"the bank without feature lists launched the coarse kernel {coarse} times")
    levels = len(BENCH_CFG.t_at_level) - 1
    check(len(calls) == levels * (1 + len(points)), f"{len(calls)} grouped-conv calls recorded")

    g = np.load(os.path.join(TESTDATA, "entry_golden.npz"))
    fn_c, args_c = port_entry(device="cpu")
    cpu_entry = fn_c(*args_c)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card_entry, cpu_entry)),
          "entry() on the card differs from the CPU")
    check(all(np.array_equal(a.cpu().numpy(), g[n]) for a, n in zip(card_entry, ("tid", "x", "y", "score", "keep"))),
          "entry() on the card differs from the JAX golden")
    s0 = time.perf_counter()
    live, sparse_eq = {}, {}
    for p in points:
        thr, b = p
        rgb_c, dep_c = (a.cpu() for a in inputs[b])
        want = detect_frame_core(rgb_c, dep_c, bank_cpu, BENCH_CFG, thr)
        check(all(torch.equal(a.cpu(), w) for a, w in zip(card[p], want)),
              f"the dense-kernel route on the card differs from the CPU at {thr}, B={b}")
        sp = detect_frame_core(*inputs[b], sparse, BENCH_CFG, thr)
        key = f"{thr}_B{b}"
        frames_of = (lambda o, f: [a[f] for a in o]) if b > 1 else (lambda o, f: o)  # noqa: E731
        sparse_eq[key] = all(same_live(frames_of(card[p], f), frames_of(sp, f)) for f in range(b))
        live[key] = int((card[p][3] >= 0).sum())
    cpu_s = time.perf_counter() - s0
    check(live[f"{LOW_THRESHOLD}_B1"] > 0, f"no live match at {LOW_THRESHOLD}: {live}")

    ms = {}
    for route, bk in (("dense", bank), ("sparse", sparse)):
        for b in DENSE_BATCHES:
            ms[f"{route}_B{b}"] = cuda_ms(lambda: detect_frame_core(*inputs[b], bk, BENCH_CFG, LOW_THRESHOLD),
                                          reps=DENSE_REPS) / b
    conv = []
    # The last points' calls are LOW_THRESHOLD's, B = 1 then 4, each from the
    # top refine level down.
    for j, c in enumerate(calls[-levels * len(DENSE_BATCHES):]):
        single = c["maps"].dim() == 3
        lead = (lambda a: a[None]) if single else (lambda a: a)  # noqa: E731
        lhs, rhs = _local_conv_operands(lead(c["maps"]), lead(c["kernels"]), lead(c["origins"]), c["t"], c["window"])
        conv.append({
            "level": levels - 1 - j % levels, "frames": 1 if single else int(c["maps"].shape[0]),
            "candidates": int(rhs.shape[0]), "t": c["t"], "kernel_hw": list(rhs.shape[-2:]),
            "channels_per_group": int(rhs.shape[1]),
            "similarity_local_ms": cuda_ms(lambda: similarity_local(c["maps"], c["kernels"], c["origins"], c["t"]),
                                           reps=DENSE_REPS),
            "conv2d_only_ms": cuda_ms(lambda: torch.nn.functional.conv2d(lhs, rhs, groups=rhs.shape[0]),
                                      reps=DENSE_REPS),
        })
        del lhs, rhs
    peak = {f"{route}_B{b}": peak_mib(lambda: detect_frame_core(*inputs[b], bk, BENCH_CFG, LOW_THRESHOLD)) / b
            for route, bk in (("dense", bank), ("sparse", sparse)) for b in DENSE_BATCHES}
    torch.cuda.empty_cache()
    emit("dense_route", t0, nvidia_smi=nvidia_smi(), launches=launches, grouped_conv_calls=len(calls),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         entry={"card_equals_cpu": True, "card_equals_jax_golden": True,
                "live": int((card_entry[3] >= 0).sum())},
         bench={"templates": int(bank.nfeats[0].shape[0]), "hw": list(frames.shape[1:3]), "top_k": BENCH_CFG.top_k,
                "card_equals_cpu_bitwise": True, "live_by_point": live,
                "equals_sparse_route_live_and_keep": sparse_eq, "cpu_reference_s": cpu_s},
         ms_per_frame_at_30=ms, grouped_conv_by_call_at_30=conv, peak_mib_per_frame_at_30=peak,
         note="ms: CUDA-event medians of whole eager calls over DENSE_REPS; the sparse route is the same bank with "
              "its lists (the local-refine kernel); peak: max_memory_allocated above the allocation before the call, "
              "per frame")
    return launches


def parallel_only(dev, smi: str) -> int:
    """``python3 chip_smoke.py parallel``: only the ``parallel`` phase and,
    with two or more cards, ``tools.bench_scaling`` over them on the bench
    workload (weak scaling, B = 4 a rank, NCCL, each rank a card).  On a
    host with four cards the phase's four ranks each get a card of their
    own over NCCL."""
    cid, det, _, frames, depths = bench_detectors(dev)
    w_mc = synthetic.multiclass_workload()
    pipe = FusedMultiClassPipeline(synthetic.multiclass_detector(w_mc, dev), w_mc["K"], device=dev,
                                   **synthetic.multiclass_pipeline_args(w_mc))
    w_ms = synthetic.multiscale_workload()
    ms_card = MultiScaleMultiClass(synthetic.multiscale_detector(w_ms, dev), w_ms["train_depth"],
                                   num_scales=w_ms["num_scales"], device=dev)
    phase_parallel(dev, cid, det, frames, depths, w_ms, w_mc, pipe, ms_card)
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        sizes = [s for s in (1, 2, 4, 8) if s <= n]
        workload = tools_scaling.bench_workload(frames_per_dev=4)
        res = run_ranks(tools_scaling.scaling_rank, max(sizes), ("cuda",) + workload + (sizes, SCALING_ITERS),
                        device_type="cuda", timeout=PARALLEL_TIMEOUT)[0]
        emit("scaling", t0, rows=tools_scaling.scaling_rows(res, "cuda", max(sizes)), workload="bench",
             hw=list(workload[2].shape[1:3]), templates=len(workload[1][0].nfeat), depth=True, frames_per_rank=4,
             threshold=workload[4], iters=SCALING_ITERS)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("env", t0, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(), nvidia_smi=smi,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {n: ptxas_summary(b["log"]) for n, b in built.items()}
    emit("build", t0, kernels={n: {"seconds": round(b["seconds"], 3), "ptxas": ptxas[n]} for n, b in built.items()})
    if sys.argv[1:] == ["parallel"]:
        return parallel_only(dev, smi)
    if sys.argv[1:] in (["coarse_score"], ["icp"]):
        (phase_coarse_score if sys.argv[1] == "coarse_score" else phase_icp)(dev)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    cid, det, det_cpu, frames, depths = bench_detectors(dev)
    calls, match_launches = phase_match_vga(dev, cid, det, det_cpu, frames, depths)
    w, mc, mc_cpu, pipe, setup_s = multiclass_setup(dev)
    mc_calls, mc_launches = phase_match_mc(dev, w, mc, mc_cpu, setup_s)
    w_ms, ms, ms_setup_s = multiscale_setup(dev)
    ms_call, ms_launches = phase_match_ms(dev, w_ms, ms, ms_setup_s)
    max_err, pool_case = phase_kernel_parity(dev, calls, mc_calls, ms_call)
    full_case, lm_case = phase_coarse_parity(dev, w, mc, mc_cpu)
    coarse_cases = phase_coarse_score(dev)
    icp_cases = phase_icp(dev)
    with counting_icp_calls("match_golden"):
        phase_match_golden(dev)
    with counting_icp_calls("refine_vga", least=1):
        launches, refine_stage = phase_refine_vga(dev, cid, det, det_cpu, frames, depths)
    render_ms = phase_render(dev)
    with tempfile.TemporaryDirectory() as tmp:
        bank_path = os.path.join(tmp, "synth_bank.npz")
        train_s, train_per_class, restored = phase_train_synth(dev, bank_path)
        with counting_icp_calls("refine_mc", least=3):
            refine_mc = phase_refine_mc(dev, w, pipe)
        with counting_icp_calls("goldens"):
            phase_refine_golden(dev)
            phase_mc_golden(dev)
            phase_ms_golden(dev)
        with counting_coarse_calls("synth_golden"), counting_icp_calls("synth_golden"):
            golden_launches = phase_synth_golden(dev)
        mc_refine_launches = finish_refine_mc(refine_mc)
        with counting_coarse_calls("synth"), counting_icp_calls("synth", least=1):
            synth_launches, svc, synth_result = phase_synth(dev, restored, train_s)
    with counting_icp_calls("lchf"):
        lchf_launches, _ = phase_lchf(dev)
    check(lchf_launches == 0, f"the LCHF path launched the refine kernel {lchf_launches} times")
    seg_launches, seg_kernels = phase_seg(dev)
    t0 = time.perf_counter()
    emit("seg_golden", t0, **phase_seg_golden(dev))
    with counting_coarse_calls("parallel"), counting_icp_calls("parallel"):
        parallel = phase_parallel(dev, cid, det, frames, depths, w_ms, w, pipe, ms["card"])
    with counting_coarse_calls("tools"), counting_icp_calls("tools"):
        tools = phase_tools(dev)
    with counting_coarse_calls("bench"), counting_icp_calls("bench"):
        bench_launches = phase_bench(dev, cid, det, det_cpu)
    with counting_coarse_calls("dense_route"), counting_icp_calls("dense_route"):
        dense_launches = phase_dense_route(dev, cid, det, det_cpu, frames, depths)
    stages = svc.metrics.snapshot()["stages"]
    synth = {
        "service_stage_ms_per_frame": {k: stages[k]["mean_ms"] for k in ("fused_dispatch", "fused_readback")},
        "device_ms_per_fused_frame": synth_result.get("device_ms_per_frame"),
        "render_ms_per_16_views": render_ms,
        "train_time_s": train_s,
        "train_seconds_per_class": train_per_class,
    }
    t0 = time.perf_counter()
    multiscale = timing_multiscale(dev, w_ms, ms, ms_call)
    multiscale["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multiclass = timing_multiclass(dev, w, mc, pipe, mc_calls[-1], full_case, lm_case)
    multiclass["seconds"] = time.perf_counter() - t0
    kern_ms, plain_ms, lib_ms, bound = phase_timing(dev, cid, det, frames, depths, calls, pool_case, refine_stage,
                                                    multiclass, multiscale, synth)
    bank = det.device_bank(cid)
    rgb, dep = frame_tensors(frames, depths, dev)
    run = TBN.refine_runner(dep, bank, refine_stage, LOW_THRESHOLD)
    phase_profile("profile", lambda: detect_frame_core(rgb, dep, bank, BENCH_CFG, 75.0))
    phase_profile("profile_refine", lambda: run(rgb))
    rgb_mc, dep_mc = torch.from_numpy(w["rgb"]).to(dev), torch.from_numpy(w["depth"].astype(np.int32)).to(dev)
    phase_profile("profile_mc", lambda: pipe(rgb_mc, dep_mc, LOW_THRESHOLD))
    rgb_ms, dep_ms = torch.from_numpy(w_ms["rgb"]).to(dev), torch.from_numpy(w_ms["depth"].astype(np.int32)).to(dev)
    phase_profile("profile_ms", lambda: ms["card"].match_arrays(rgb_ms, dep_ms, LOW_THRESHOLD))
    rgb_s, dep_s = synth_scene(dev)
    phase_profile("profile_synth", lambda: svc.process_frame(rgb_s, dep_s))
    by_phase = {"match_vga": match_launches, "refine_vga": launches, "match_mc": mc_launches,
                "refine_mc": mc_refine_launches, "match_ms": ms_launches, "synth_golden": golden_launches,
                "synth": synth_launches, "lchf": lchf_launches, "seg": seg_launches["local_refine"],
                "parallel": parallel["launches"], "tools": tools["launches"], "bench": bench_launches,
                "dense_route": dense_launches}
    mc_kernel = multiclass["refine_kernel_K1152"]
    ms_kernel = multiscale["refine_kernel_K1920_scaled"]

    print(json.dumps({"kernels": [{
        "name": "local_refine",
        "route": "cuda",
        "source": "sixdpose_tpu_torch/csrc/local_refine.cu",
        "replaces": REPLACES,
        "launches": sum(by_phase.values()),
        "launches_by_phase": by_phase,
        "exact_vs_plain": True,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": lib_ms,
        "ptxas": ptxas["local_refine"],
        "at_multiclass_call_K1152": {"ms": mc_kernel["kernel_ms"], "plain_ms": mc_kernel["plain_ms"],
                                     "bound_ms": mc_kernel["bound"]["bound_ms"], "bound_by": mc_kernel["bound"]["bound_by"],
                                     "library_ms": mc_kernel["library_grouped_conv_ms"]},
        "at_multiscale_call_K1920_scaled": {"ms": ms_kernel["kernel_ms"], "plain_ms": ms_kernel["plain_ms"],
                                            "bound_ms": ms_kernel["bound"]["bound_ms"],
                                            "bound_by": ms_kernel["bound"]["bound_by"],
                                            "library_ms": ms_kernel["library_grouped_conv_ms"]},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"sixdpose_tpu_torch/csrc/{name}.cu",
        "replaces": SEG_REPLACES[name],
        "launches": seg_launches[name],
        "launches_by_phase": {"seg": seg_launches[name]},
        "exact_vs_plain": True,
        **{k: seg_kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: seg_kernels[name][k] for k in ("split_ms", "chain_bound_ms") if k in seg_kernels[name]},
        "ptxas": ptxas[name],
        "at": {k: v for k, v in seg_kernels[name].items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "split_ms",
                            "chain_bound_ms")},
    } for name in ("segment_sum", "floyd_steinberg")] + [{
        "name": "coarse_score",
        "route": "cuda",
        "source": "sixdpose_tpu_torch/csrc/coarse_score.cu",
        "replaces": "no TPU kernel: the JAX package's shift-bucketed XLA matmuls (sixdpose_tpu/ops/similarity.py), "
                    "which the port ran as one addmm per shift bucket before this kernel",
        "launches": sum(COARSE_BY_PHASE.values()),
        "launches_by_phase": COARSE_BY_PHASE,
        "exact_vs_plain": True,
        **{k: coarse_cases["tless"][k] for k in ("kernel_ms", "plain_ms", "library_ms")},
        "bound_ms": coarse_cases["tless"]["bound"]["bound_ms"],
        "bound_by": coarse_cases["tless"]["bound"]["bound_by"],
        "ptxas": ptxas["coarse_score"],
        "at_linemod_call": {k: coarse_cases["linemod"][k] for k in ("kernel_ms", "plain_ms", "library_ms")},
    }, {
        "name": "icp",
        "route": "cuda",
        "source": "sixdpose_tpu_torch/csrc/icp.cu",
        "replaces": "no TPU kernel: the JAX package's XLA program of icp_batch (sixdpose_tpu/models/refine.py), "
                    "which the port ran as eager PyTorch, about 300 kernels an iteration",
        "launches": sum(ICP_BY_PHASE.values()),
        "launches_by_phase": ICP_BY_PHASE,
        "exact_vs_plain": True,
        **{k: icp_cases["tless_fused"][k] for k in ("kernel_ms", "plain_ms", "library_ms")},
        "bound_ms": icp_cases["tless_fused"]["bound"]["bound_ms"],
        "bound_by": icp_cases["tless_fused"]["bound"]["bound_by"],
        "ptxas": ptxas["icp"],
        "at_linemod_host_call": {k: icp_cases["linemod_host"][k] for k in ("kernel_ms", "plain_ms", "library_ms")},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
