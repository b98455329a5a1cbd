"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels (yasph2d_tpu_torch/csrc) with nvcc, one
     process per source, all started together;
  3. kernels: each kernel against its plain PyTorch twin on the same CUDA
     tensors, at the 100k double dam-break shapes: the nine call forms of the
     pair kernel K1, with float32 and with bfloat16 operands, and its two
     physical viscosity forms (visc_gravity_phys, wcsph_forces_phys: the
     XSPH forms' operands with PhysicalViscosityModel, mu = 0.01), and the
     re-bucket K2 on the plane states of the DFSPH and WCSPH steps; the eight
     forms of the slot-major pair kernel K3 (three WCSPH, five DFSPH; K5's
     tile kernel in K3's sum order) and the slot-major re-bucket K4 with the
     WCSPH (D = 2) and DFSPH (D = 4) payloads on the padded states; the seven
     forms of the tiled pair kernel K5 (four DFSPH, three WCSPH) on the
     padded states of its route, in f32 and in K5's bf16 math mode (on the
     states of the bf16 K5 paths; records `tile_pair_reduce_<form>_bf16`);
     K1's three forms without an epilogue of the unfused DFSPH plane step
     (visc, div, corr; f32 records, bf16 operands checked only, visc_phys
     timed); and K3's and K5's physical forms
     (dfsph_visc_phys, wcsph_forces_phys). The physical forms are checked
     and timed here beside their XSPH forms on the same operands, but their
     records come from phase 5, where they launch. The WCSPH states
     are taken after 3 steps, the DFSPH states after 60, when the columns
     touch the walls and every fluid -> boundary pass must sum something. Then,
     at the TPU probes' shapes, the speed probes K6 (FMA chains x4 and x8, the
     compare/select/add mix x8, 1,690,624 elements; rtol 1e-5 on the TPU
     probe's constant input and on a seeded input spread across 0.5) and the
     ctx-pass probe K7 (K1's kernel with the probe's statement; 64 x 1612
     cells, P 7) beside K1's ctx form on the same inputs. Then K1's eleven
     forms and its three no-epilogue forms and visc_phys in both operand
     modes, K3's ten and K7 with a source space of
     40 slots a cell (more than 32 live: two live words), on a synthetic
     ragged grid (checked only). K1's, K3's and K7's forms must be bit-equal
     to their twins (max_abs_err 0.0), K5's agree to rtol 1e-5 plus 1e-6 of
     each output component's largest live magnitude, in either math mode
     (in bf16 both round each operation alike: what remains is the sum
     order); the re-buckets
     bit-equal, with and without forced cell overflow (each timed as its
     steps call it: one launch, the payload planes (K2) or parts (K4, one
     record per payload width D) by pointer). Then, where the device and not the host sets the pace, K1's
     six DFSPH forms in bfloat16 and K2 on the 1M state that the roofline
     path settles (records `*_1m`, whose launches are those of the roofline
     path; every other record's are those of the 100k solver paths, never of
     a tool's). `ms` is the kernel's device time: 10
     wrapper calls captured in a CUDA graph, each replay timed with CUDA
     events, median of 7, over 10; `plain_ms` the twin's, eager, CUDA events,
     median of 7. `bound_ms` is the larger of the bytes the call must move
     over 3.35 TB/s and its float32 operations (counted from the live
     candidate and valid pair counts of these inputs, K5's bf16 mode its
     own valid pairs and twice the operations, each followed by its
     rounding; K6's FMA chains as the
     TPU probe counts them, an FMA as 2) over 67 TFLOP/s, the H100 SXM's
     data-sheet rates; K6's mix, whose compare and select are no FP32
     arithmetic, by its SASS instructions (one FSETP, FSEL and FADD a step)
     at each pipe's rate from NVIDIA's arithmetic instruction throughput
     table for compute capability 9.0 (the counting rules live in
     yasph2d_tpu_torch/tools/roofline.py). Every pair call is timed and its
     bound logged (K5's pass to the walls too); a record keeps its form's
     first call's.
     The bytes: every mask read once in full, positions and values only of
     the slots that can change the result (live queries; live sources in the
     3x3 cells of a live query; the live slots a re-bucket moves), K6's
     input once, every output written once in full. No single PyTorch call
     computes any of these functions, so `library_ms` is null;
  4. small reference: a 3k-particle scene stepped through the kernels on the
     GPU and through the twins on the CPU must agree, for every solver path
     (the table paths, plain tensor operations, on the card against the
     CPU):
     5 steps from rest with XSPH and with physical viscosity, and for the
     DFSPH paths, with either viscosity (the table and sorted paths with XSPH
     only: their physical forms are the padded paths'), 5 more from the
     GPU's state after
     55 steps, where the columns touch the walls, the divergence loop
     iterates and warm-starts, and the fluid -> boundary pass sums something;
  5. main paths: init_carry + 20 steps of the 100k double dam-break through the
     kernels, for each solver, route and operand dtype of SOLVER_PATHS, with
     the launch count of every kernel of that path > 0 (the table paths
     `dfsph_table`, `wcsph_table` have none; the sorted paths `dfsph_dense`,
     `wcsph_dense` run K3, their `_k5` twins and `dfsph_dense_k5_bf16` K5,
     and neither launches a re-bucket, which is checked), every tensor of the
     final carry on the card, no dropped particle,
     all 99,372 particles live, finite state and densities in [rho0, 1.3 rho0]
     (the columns are still falling; after the impact, by step 60, the
     densest particle of the DFSPH plane step reaches 1.55 rho0, so phases 3
     and 4 check the contact regime instead); the unfused DFSPH plane path
     with the fused path's per-step iterations and drops (whether the live
     rows are bit-equal is logged), the K5 bf16 paths with sorted positions
     within 0.2 h of the K5 f32 paths'; the table and sorted paths' sorted
     positions beside the padded path of the same step (logged). Then the
     tools of TOOL_PATHS
     through their entry points, each with its launch counts > 0: the K6
     rates (FMA, mix, HBM stream), the K7 probe beside K1 ctx, and the
     roofline at 1M particles in bfloat16 after 100 settle steps, whose state
     must have no drop, every particle live and finite values (no density
     gate: the columns have hit the floor). Then the configured entry point,
     CONFIG_PATHS: BASELINE config 3 (bench.py:353-361: the reference
     dam-break, here at ~100k fluid particles, physical viscosity mu = 0.01)
     written as a SimulationConfig JSON for each config kind and operand
     mode and run by `python -m yasph2d_tpu_torch run` in-process
     (`__main__.main`), each with its kernels' launch counts > 0, no drop,
     every fluid particle live, finite state and densities in [rho0,
     1.3 rho0] at its end. Fourteen paths (two of them the padded kinds
     with pair_dtype bfloat16: K5's bf16 math mode; four the table and
     sorted kinds `dfsph`, `wcsph`, `dfsph_dense`, `wcsph_dense`, which
     launch no re-bucket) take 10-20 steps, in free fall; the
     rebuild_every 3 path takes CONTACT_CONFIG (150) steps, through the
     impact on the ramp, with one K4 launch per block of 3 steps and per
     leftover step, and must end in wall contact. After each such run,
     every pair form of the path is held against its twin on the run's
     final state, with phase 3's seeded noise; the physical forms' records
     are these calls' (times, bound) and their launches on these paths;
  6. sharded: the spatially sharded solvers (yasph2d_tpu_torch/parallel/)
     on the 100k double dam-break on a grid whose rows split over two shards
     (515 x 326, P 7), every fluid particle kicked SHARD_KICK m/s upward so
     that the columns' tops, a cell under the seam, cross it; SHARD_STEPS
     steps, against the one-device solver on the same grid and state: one
     NCCL rank in this process (DFSPH plane f32; host ms/step beside the
     one-device solver's), two gloo ranks sharing the card, spawned (the
     plane solvers: DFSPH f32, DFSPH bf16, WCSPH f32, and the unfused DFSPH
     step; the padded K5 solvers: DFSPH and WCSPH, each with XSPH and with
     physical viscosity, and DFSPH in bf16; halo rows
     staged through the host), and two NCCL ranks on two cards (DFSPH plane
     and padded K5) where the machine has two (else a line says why not).
     Each run must give the one-device per-step iterations and drops, every
     fluid particle live, the live rows bit-equal (a padded run may instead
     give the same iterations with live positions within 5e-5, the JAX
     test's tolerance, should a residual average move an exit; the log says
     which held), and with two shards a net seam crossing above 0; the
     largest relative difference of the residual averages (sums of
     per-shard sums) is logged. The two-rank runs' launches are the halo
     forms' (K1 `<form>[_bf16]_halo`, K2 `rebucket_halo`, K5
     `tile_pair_reduce_<form>[_bf16]_halo`, K4 `sm_rebucket_halo`), summed over the
     ranks; the one-rank mesh has no halo and launches the one-device
     kernels, whose records count the 100k solver paths only. Then the halo
     forms against their twins on the two shards' states (the one-device
     final state, equal to the gathered sharded one, cut at the seam), K1,
     K2 and K4 bit-equal, K5 at its tolerance, RECORD on shard 0: K1's and
     K5's forms as phase 3 calls them, K2 (records `rebucket_halo`, the
     DFSPH payload, and `rebucket_halo_wcsph`, the WCSPH one) and K4
     (`sm_rebucket_halo`, D = 4, and `sm_rebucket_halo_wcsph`, D = 2) with
     their step's payload; their bounds add the halo rows' bytes (masks in
     full; positions and values of the live halo slots next to a live query
     of the edge row; for the re-buckets the live halo slots' positions and
     the arrivals' payload) and count candidates and pairs across the seam;
     the two shards' K2 and K4 outputs must be the one-device re-bucket's
     rows, forced overflow included;
  7. app: `python -m yasph2d_tpu_torch record` in-process (`__main__.main`)
     on BASELINE config 3's scene (the reference dam-break at ~100k fluid
     particles; only the kind and the world reach the app, XSPH viscosity)
     for the app's default kind, the table `dfsph` (no kernel: its
     checks against twins are skipped), for `dfsph_padded` (K5 + K4) and
     for `dfsph_plane` (K1 + K2), APP_FRAMES (24) frames of 1/60 s at 1920x1080 into a
     temporary directory: the kind's kernels launched, no drop, every fluid
     particle live, finite state, no app warning, `flush()` 0, the PNGs
     named as the Recorder names them, each decoded with the standard
     library's zlib to 1080x1920x3 with fluid pixels, the last one the
     native renderer's frame of the final state, and the native and NumPy
     renderers within 1% of pixels there; steps per frame and the host ms
     of each frame's simulate, render (read-back + rasterise) and submit
     parts, and the final flush, are logged. Then APP_REALTIME_FRAMES (10; 2
     for the table kind, whose frames take ~250 steps at ~11 ms)
     realtime frames on the same app: whether the governor dropped steps is
     logged, not gated. Every pair form and the re-bucket the app's step
     launches are held against their twins on the record's final state, at
     the app's own shapes (phase 5's config grid with XSPH viscosity),
     check-only. The app's launches are on its own lines; the kernel records
     keep those of the paths above. The native host library (g++) is built
     in phase 2 after the kernels.

The line before the last is the GPU's name and power limit as nvidia-smi
reports them, the one before that the per-kernel JSON record; the last line is
{"ok": true, "device": ...}. Any failed phase raises, exits non-zero and
prints no result. Imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import time
from functools import partial

import numpy as np
import torch

from yasph2d_tpu_torch.tools.roofline import (
    BF16_OPS_FACTOR,
    OPS_PER_PAIR,
    OPS_PER_QUERY,
    OPS_PER_SLOT_REBUCKET,
    bound,
    instruction_bound,
    nbytes,
    pair_bytes,
    pair_counts,
    plane_pairs,
    rebucket_bytes,
)
from yasph2d_tpu_torch.utils.cuda_timing import event_ms, graph_ms

STEPS = 20
N_FLUID = 99_372
WARMUP_STEPS = 3  # the WCSPH kernel states
CONTACT_STEPS = 60  # the DFSPH kernel states: the columns touch the walls
CONTACT_STEPS_3K = 55  # the same on the 3k scene of phase 4
ROOFLINE = ("1000000", "100")  # tools.roofline: particles, settle steps (bf16)
SIZE_1M = "_1m"  # the suffix of the records on the roofline's 1M state
DEEP_PS = 40  # source slots a cell of the deep-source checks: two live words
CSRC = "yasph2d_tpu_torch/csrc/"
SOURCES = {
    "pair_reduce": CSRC + "pair_reduce.cu",
    "pair_reduce_halo": CSRC + "pair_reduce_halo.cu",
    "rebucket": CSRC + "rebucket.cu",
    "rebucket_halo": CSRC + "rebucket.cu",
    "sm_pair_reduce": CSRC + "tile_pair_reduce.cu",
    "sm_rebucket": CSRC + "sm_rebucket.cu",
    "tile_pair_reduce": CSRC + "tile_pair_reduce.cu",
    "tile_pair_reduce_halo": CSRC + "tile_pair_reduce_halo.cu",
    "sm_rebucket_halo": CSRC + "sm_rebucket.cu",
    "vpu_probe": CSRC + "vpu_probe.cu",
    "probe_ctx": CSRC + "pair_reduce.cu",
}
REPLACES = {
    "pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:821",  # pf_pair_reduce
    # under sharding: its source windows' rows from the neighbours (_pf_halo)
    "pair_reduce_halo": "yasph2d_tpu/ops/pallas_slotmajor.py:821",
    "rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1120",  # pf_rebucket
    # under sharding (row0): its halo rows are the migration
    "rebucket_halo": "yasph2d_tpu/ops/pallas_slotmajor.py:1120",
    "sm_pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:252",  # sm_pair_reduce
    "sm_rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1263",  # sm_rebucket
    "tile_pair_reduce": "yasph2d_tpu/ops/pallas_pair.py:97",  # pallas_pair_reduce
    # under sharding: the source's rows -1 and ny from the neighbours (the JAX
    # sharded route runs this pass in XLA, dense_grid.pair_reduce with halo2d_multi)
    "tile_pair_reduce_halo": "yasph2d_tpu/ops/pallas_pair.py:97",
    # under sharding (row0): its halo rows are the migration (JAX: XLA
    # dense_grid.rebucket(row0=...))
    "sm_rebucket_halo": "yasph2d_tpu/ops/pallas_slotmajor.py:1263",
    "vpu_probe_fma": "tools/vpu_probe.py:39",  # fma_probe
    "vpu_probe_mix": "tools/vpu_probe.py:76",  # mix_probe
    "probe_ctx": "tools/probe_pallas_slotmajor.py:113",  # ctx_pass_slotmajor
}
BIT_EQUAL = ("pair_reduce", "sm_pair_reduce")  # pair kernels whose twins sum in their order
DFSPH_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v")
WCSPH_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces")
DFSPH_SM_FORMS = ("dfsph_ctx", "dfsph_stat", "dfsph_div", "dfsph_corr", "dfsph_visc")
DFSPH_TILE_FORMS = ("dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc")
# the unfused DFSPH plane step's K1 forms (both fuse switches off): the ctx
# form on fluid sources too, and the passes without an epilogue
DFSPH_UNFUSED_FORMS = ("ctx", "visc", "div", "corr")
BF16 = "_bf16"  # the suffix of K1's bf16-operand and K5's bf16-math launchers
# the kernels each main path must launch: the solvers' steps, then the tools
SOLVER_PATHS = {
    "dfsph_plane": [f"pair_reduce_{f}" for f in DFSPH_FORMS] + ["rebucket"],
    "wcsph_padded": [f"sm_pair_reduce_{f}" for f in WCSPH_FORMS] + ["sm_rebucket"],
    "wcsph_plane": [f"pair_reduce_{f}" for f in WCSPH_FORMS] + ["rebucket"],
    "dfsph_padded": [f"sm_pair_reduce_{f}" for f in DFSPH_SM_FORMS] + ["sm_rebucket"],
    "dfsph_padded_k5": [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_FORMS]
    + ["sm_rebucket"],
    "wcsph_padded_k5": [f"tile_pair_reduce_{f}" for f in WCSPH_FORMS] + ["sm_rebucket"],
    "dfsph_plane_bf16": [f"pair_reduce_{f}_bf16" for f in DFSPH_FORMS] + ["rebucket"],
    "wcsph_plane_bf16": [f"pair_reduce_{f}_bf16" for f in WCSPH_FORMS] + ["rebucket"],
    "dfsph_plane_unfused": [f"pair_reduce_{f}" for f in DFSPH_UNFUSED_FORMS] + ["rebucket"],
    "dfsph_padded_k5_bf16": [f"tile_pair_reduce_{f}{BF16}" for f in DFSPH_TILE_FORMS]
    + ["sm_rebucket"],
    "wcsph_padded_k5_bf16": [f"tile_pair_reduce_{f}{BF16}" for f in WCSPH_FORMS]
    + ["sm_rebucket"],
    # the table solvers: plain tensor operations, no kernel; the sorted
    # solvers: K3 or K5, rebuilt by a sort (no re-bucket)
    "dfsph_table": [],
    "wcsph_table": [],
    "dfsph_dense": [f"sm_pair_reduce_{f}" for f in DFSPH_SM_FORMS],
    "dfsph_dense_k5": [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_FORMS],
    "wcsph_dense": [f"sm_pair_reduce_{f}" for f in WCSPH_FORMS],
    "wcsph_dense_k5": [f"tile_pair_reduce_{f}" for f in WCSPH_FORMS],
    "dfsph_dense_k5_bf16": [f"tile_pair_reduce_{f}{BF16}" for f in DFSPH_TILE_FORMS],
}
# the paths that must launch no re-bucket (K2, K4): the table and sorted ones
NO_REBUCKET = ("dfsph_table", "wcsph_table", "dfsph_dense", "dfsph_dense_k5", "wcsph_dense",
               "wcsph_dense_k5", "dfsph_dense_k5_bf16", "config_dfsph", "config_wcsph",
               "config_dfsph_dense", "config_wcsph_dense")
# the main paths held against a path of the same step: the unfused DFSPH
# plane step against the fused one (the same per-step iterations and drops;
# whether the live rows are bit-equal is logged), the K5 bf16 paths against
# the K5 f32 ones (sorted positions within BF16_POSITION_TOL h)
FUSED_OF = {"dfsph_plane_unfused": "dfsph_plane"}
F32_OF = {"dfsph_padded_k5_bf16": "dfsph_padded_k5", "wcsph_padded_k5_bf16": "wcsph_padded_k5",
          "dfsph_dense_k5_bf16": "dfsph_dense_k5"}
# the table and sorted paths beside the padded path of the same step: the
# largest difference of their sorted positions is logged (not gated: the
# layouts sum in other orders)
LAYOUT_OF = {"dfsph_table": "dfsph_padded_k5", "dfsph_dense": "dfsph_padded",
             "dfsph_dense_k5": "dfsph_padded_k5", "wcsph_table": "wcsph_padded_k5",
             "wcsph_dense": "wcsph_padded", "wcsph_dense_k5": "wcsph_padded_k5"}
BF16_POSITION_TOL = 0.2  # JAX's bf16-vs-f32 bound (tests/test_bf16_pairs.py:104-105)
VPU_PROBES = ["vpu_probe_fma4", "vpu_probe_fma8", "vpu_probe_mix8"]
TOOL_PATHS = {
    "vpu_probe": VPU_PROBES,
    "probe_ctx": ["probe_ctx", "pair_reduce_ctx"],
    "roofline": [f"pair_reduce_{f}_bf16" for f in DFSPH_FORMS] + ["rebucket"] + VPU_PROBES,
}
# the physical viscosity forms (PhysicalViscosityModel) of each kernel
PHYS = "_phys"
DFSPH_PHYS_FORMS = tuple(f + PHYS if f == "visc_gravity" else f for f in DFSPH_FORMS)
WCSPH_PHYS_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces" + PHYS)
DFSPH_SM_PHYS_FORMS = DFSPH_SM_FORMS[:-1] + ("dfsph_visc" + PHYS,)
DFSPH_TILE_PHYS_FORMS = DFSPH_TILE_FORMS[:-1] + ("dfsph_visc" + PHYS,)
# what a check does with its pair call: RECORD checks it against its twin,
# times it, logs its bound and keeps its record; TIME all but keep it; CHECK
# only checks it
RECORD, TIME, CHECK = "record", "time", "check"
CONFIG_PARTICLES = 100_000
CONFIG_DIR = "build/chip_smoke"  # git-ignored: the paths' config files
# steps of the config path that runs through contact: the fluid falls onto the
# ramp at ~step 100 (densities up to ~1.64 rho0 at the impact) and has settled
# to under 1.03 rho0 by step 150, with stale steps all the while
CONTACT_CONFIG = 150
# BASELINE config 3 (dfsph_high_viscosity) through `python -m yasph2d_tpu_torch
# run`, per solver kind: (config kind, solver knobs, steps, kernels launched)
CONFIG_PATHS = {
    "config_dfsph_plane": ("dfsph_plane", {}, STEPS,
                           [f"pair_reduce_{f}" for f in DFSPH_PHYS_FORMS] + ["rebucket"]),
    "config_dfsph_plane_bf16": ("dfsph_plane", {"pair_dtype": "bfloat16"}, 10,
                                [f"pair_reduce_{f}_bf16" for f in DFSPH_PHYS_FORMS]
                                + ["rebucket"]),
    "config_dfsph_padded": ("dfsph_padded", {"use_pallas_slotmajor": True}, 10,
                            [f"sm_pair_reduce_{f}" for f in DFSPH_SM_PHYS_FORMS]
                            + ["sm_rebucket"]),
    "config_dfsph_padded_k5": ("dfsph_padded", {}, 10,
                               [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_PHYS_FORMS]
                               + ["sm_rebucket"]),
    "config_wcsph_plane": ("wcsph_plane", {}, 10,
                           [f"pair_reduce_{f}" for f in WCSPH_PHYS_FORMS] + ["rebucket"]),
    "config_wcsph_plane_bf16": ("wcsph_plane", {"pair_dtype": "bfloat16"}, 10,
                                [f"pair_reduce_{f}_bf16" for f in WCSPH_PHYS_FORMS]
                                + ["rebucket"]),
    "config_wcsph_padded": ("wcsph_padded", {"use_pallas_slotmajor": True}, 10,
                            [f"sm_pair_reduce_{f}" for f in WCSPH_PHYS_FORMS]
                            + ["sm_rebucket"]),
    "config_wcsph_padded_k5": ("wcsph_padded", {}, 10,
                               [f"tile_pair_reduce_{f}" for f in WCSPH_PHYS_FORMS]
                               + ["sm_rebucket"]),
    "config_dfsph_padded_k5_rebuild3": (
        "dfsph_padded", {"rebuild_every": 3}, CONTACT_CONFIG,
        [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_PHYS_FORMS] + ["sm_rebucket"]),
    "config_dfsph_padded_k5_bf16": ("dfsph_padded", {"pair_dtype": "bfloat16"}, 10,
                                    [f"tile_pair_reduce_{f}{BF16}"
                                     for f in DFSPH_TILE_PHYS_FORMS] + ["sm_rebucket"]),
    "config_wcsph_padded_k5_bf16": ("wcsph_padded", {"pair_dtype": "bfloat16"}, 10,
                                    [f"tile_pair_reduce_{f}{BF16}" for f in WCSPH_PHYS_FORMS]
                                    + ["sm_rebucket"]),
    # the table kinds (no kernel) and the sorted kinds (K5, the config's route)
    "config_dfsph": ("dfsph", {}, 10, []),
    "config_wcsph": ("wcsph", {}, 10, []),
    "config_dfsph_dense": ("dfsph_dense", {}, 10,
                           [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_PHYS_FORMS]),
    "config_wcsph_dense": ("wcsph_dense", {}, 10,
                           [f"tile_pair_reduce_{f}" for f in WCSPH_PHYS_FORMS]),
}
# the sharded phase: the 100k double dam-break on a grid whose rows split over
# two shards (515 x 326, P 7), every fluid particle kicked SHARD_KICK m/s
# upward so that the columns' tops, a cell under the seam, cross it;
# SHARD_STEPS steps of each kind, against the one-device solver on that grid.
# The plane kinds (K1, K2), then the padded K5 kinds (K5, K4), each also with
# physical viscosity (`_phys`), whose forces forms are the *_phys ones
SHARD_PARTICLES = 100_000
SHARD_STEPS = 40
SHARD_KICK = 1.5
SHARD_RANKS = 2
SHARD_KINDS = ("dfsph_plane", "dfsph_plane_bf16", "wcsph_plane", "dfsph_plane_unfused")
PADDED_SHARD_KINDS = ("dfsph_padded_k5", "wcsph_padded_k5", "dfsph_padded_k5" + PHYS,
                      "wcsph_padded_k5" + PHYS, "dfsph_padded_k5_bf16")
HALO = "_halo"


def halo_path(kind):
    variant = BF16 if kind.endswith(BF16) else ""
    if "padded" in kind:
        phys = kind.endswith(PHYS)
        forms = ((DFSPH_TILE_PHYS_FORMS if phys else DFSPH_TILE_FORMS)
                 if kind.startswith("dfsph") else (WCSPH_PHYS_FORMS if phys else WCSPH_FORMS))
        return [f"tile_pair_reduce_{f}{variant}{HALO}" for f in forms] + ["sm_rebucket" + HALO]
    forms = (DFSPH_UNFUSED_FORMS if kind.endswith("_unfused") else DFSPH_FORMS) \
        if kind.startswith("dfsph") else WCSPH_FORMS
    return [f"pair_reduce_{f}{variant}{HALO}" for f in forms] + ["rebucket" + HALO]


# one rank over NCCL (a one-shard mesh has no halo: the one-device kernels,
# whose records count the 100k solver paths only), two gloo ranks sharing the
# card, and two NCCL ranks on two cards where there are two
ONE_RANK = "sharded1_nccl_dfsph_plane"
NCCL_KINDS = ("dfsph_plane", "dfsph_padded_k5")
SHARDED_PATHS = {
    ONE_RANK: SOLVER_PATHS["dfsph_plane"],
    **{f"sharded2_gloo_{kind}": halo_path(kind) for kind in SHARD_KINDS + PADDED_SHARD_KINDS},
    **{f"sharded2_nccl_{kind}": halo_path(kind) for kind in NCCL_KINDS},
}
# the app phase: `python -m yasph2d_tpu_torch record` on BASELINE config 3's
# scene (the reference dam-break at ~CONFIG_PARTICLES) for each of these
# kinds, APP_FRAMES frames of 1/60 s at APP_RESOLUTION, then
# APP_REALTIME_FRAMES realtime frames on the same app. Only the kind and the
# world reach the app (XSPH viscosity, as the JAX record command): the
# app's default kind, the table `dfsph` (no kernel), the padded kind on the
# K5 route (the app keeps use_pallas_slotmajor False), the plane kind on
# K1 + K2
APP_FRAMES = 24
APP_REALTIME_FRAMES = 10
APP_REALTIME_FRAMES_TABLE = 2  # the table kind: ~250 steps at ~11 ms a frame
APP_RESOLUTION = (1920, 1080)
APP_PATHS = {
    "app_dfsph": ("dfsph", SOLVER_PATHS["dfsph_table"]),
    "app_dfsph_padded": ("dfsph_padded", SOLVER_PATHS["dfsph_padded_k5"]),
    "app_dfsph_plane": ("dfsph_plane", SOLVER_PATHS["dfsph_plane"]),
}
PATHS = {**SOLVER_PATHS, **TOOL_PATHS, **{k: v[3] for k, v in CONFIG_PATHS.items()},
         **SHARDED_PATHS}


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase_clock(name):
    """Log the host seconds the block took."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def role_tensors(q_pos, s_pos, kw):
    """(query-side, source-side) input tensors of a pair call: positions,
    values, and (K1) the epilogue's per-query planes."""
    q = [q_pos, *kw.get("q_vals", ()), *kw.get("post_planes", ())]
    return q, [s_pos, *kw.get("s_vals", ())]


def pair_error(kernel_out, twin_out, live, comp_dim):
    """(max abs error on live slots per output component, passes): rtol 1e-5
    plus 1e-6 of the component's largest live magnitude (at least 1), so a
    small component (a neighbour count) is not held to a large one's scale.
    `comp_dim` is the output's component axis, `live` the slot mask."""
    a = kernel_out.movedim(comp_dim, -1)[live]
    b = twin_out.movedim(comp_dim, -1)[live]
    if b.shape[0] == 0:
        return [0.0] * b.shape[1], bool(torch.isfinite(a).all())
    err = (a - b).abs()
    scale = b.abs().amax(0).clamp(min=1.0)
    ok = bool(torch.isfinite(a).all()) and bool((err <= 1e-5 * b.abs() + 1e-6 * scale).all())
    return err.amax(0).tolist(), ok


def bit_equal(outs_k, outs_t) -> bool:
    def bits(a):
        return a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(outs_k, outs_t))


def bound_line(name, bound_ms, bound_by, what, ms):
    log(f"phase 3 kernels: {name} bound {bound_ms:.5f} ms by {bound_by} ({what}), "
        f"kernel {ms:.5f} ms, {bound_ms / ms:.3f} of the bound")


class Records:
    """The per-kernel JSON records; a kernel checked in several calls keeps
    the first recorded call's times and bound, and the largest error of all
    its calls. A record's launches are its counter's counts on the main paths
    it lists (the 100k solver paths, SOLVER_PATHS, when None)."""

    def __init__(self):
        self.by_name = {}
        self.nonzero = set()
        self.worst = {}  # the largest error of each name's calls so far

    def add(self, name, kernel, max_abs_err, ms, plain_ms, bound_ms, bound_by,
            counter=None, paths=None, replaces=None, source=None):
        max_abs_err = self.worst[name] = max(self.worst.get(name, 0.0), max_abs_err)
        if name in self.by_name:
            self.by_name[name]["max_abs_err"] = max_abs_err
            return
        self.by_name[name] = dict(
            name=name, route="cuda", source=SOURCES[source or kernel],
            replaces=REPLACES[replaces or source or kernel],
            launches=0, max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            _counter=counter or name, _paths=paths)

    def check_pair(self, kernel, label, form, run_kernel, run_twin, live, comp_dim,
                   roles, masks, pairs, radius_sq, variant="", size="", paths=None,
                   mode=RECORD, where="", halo=None):
        """`live`: the query slot mask, `comp_dim` the output's component
        axis; `roles`: the (query-side, source-side) input tensors and `masks`
        the input masks, for its bytes; `pairs`: (q_pos, q_mask, s_pos,
        s_mask) in the slot layout and the cutoff, for its needed slots and
        operation count; `variant`: the operand mode's suffix of the launch
        name ("_bf16" for K1's bf16 operands, whose `pairs` are rebased,
        and for K5's bf16 math mode, whose `pairs` carry its Rebase sixth,
        after a None); `size`: a suffix of the record's name for another
        state than the 100k one, whose launches are counted on `paths`;
        `mode` RECORD, TIME or CHECK; `where` names the state in the log;
        `halo`, for the halo forms: (the call's `pairs` with the source's
        halo rows, the bytes it reads from them). K1 and K3 must be
        bit-equal to their twins, K5 within `pair_error`. The record keeps
        its form's first RECORD call's times and bound."""
        out_k, out_t = run_kernel(), run_twin()
        torch.cuda.synchronize()
        errs, ok = pair_error(out_k, out_t, live, comp_dim)
        exact = kernel in BIT_EQUAL
        if exact:
            ok = bit_equal([out_k], [out_t])
        err = max(errs)
        nonzero = bool(out_t.movedim(comp_dim, -1)[live].abs().sum() > 0)
        counter = f"{kernel}_{form.name}{variant}"
        name = counter + size
        label = f"{label}{variant}{size}{where}"
        if nonzero:
            self.nonzero.update((name, f"{kernel}_{label}"))
        log(f"phase 3 kernels: {kernel}_{label} max_abs_err {err!r} per component "
            f"{errs!r} {'ok' if ok else 'MISMATCH'}"
            f"{' (bit-equal required)' if exact else ''} nonzero {nonzero}")
        if not ok:
            raise RuntimeError(f"{kernel}_{label} disagrees with its twin "
                               f"(max_abs_err per component {errs})")
        if mode != RECORD:  # the error counts all the same
            self.worst[name] = max(self.worst.get(name, 0.0), err)
            if name in self.by_name:
                self.by_name[name]["max_abs_err"] = self.worst[name]
        if mode == CHECK:
            return
        ms, plain_ms = graph_ms(run_kernel), event_ms(run_twin)
        counted = pairs if halo is None else halo[0]
        rebase = counted[5] if len(counted) > 5 else None  # K5's bf16 math mode
        cand, valid = pair_counts(*counted[:4], radius_sq,
                                  rebase_cell=counted[4] if len(counted) > 4 else None,
                                  rebase=rebase)
        n_live = int(pairs[1].sum())
        n_ops = (5 * cand + OPS_PER_PAIR[form.name] * valid
                 + OPS_PER_QUERY.get(form.name, 0) * n_live) \
            * (1 if rebase is None else BF16_OPS_FACTOR)
        log(f"phase 3 kernels: {kernel}_{label} kernel {ms:.5f} ms twin {plain_ms:.4f} ms, "
            f"{n_live} live queries, {cand} live candidates, {valid} valid pairs")
        n_bytes = pair_bytes(*roles, masks, [out_k], pairs[1], pairs[3]) + (
            0 if halo is None else halo[1])
        bound_ms, bound_by = bound(n_bytes, n_ops)
        bound_line(f"{kernel}_{label}", bound_ms, bound_by,
                   f"{n_bytes} bytes, {n_ops} float32 operations", ms)
        if mode == RECORD:
            self.add(name, kernel, err, ms, plain_ms, bound_ms, bound_by, counter=counter,
                     paths=paths, source=None if halo is None else kernel + HALO)

    def check_rebucket(self, kernel, label, run_kernel, run_twin, overflow, inputs,
                       name=None, paths=None, halo=None):
        """`inputs`: the call's (positions, mask, payload); `run_kernel` may
        return the payload as a tuple of parts (`rebucket_planes` of K2,
        `sm_rebucket_parts` of K4), compared stacked as the twin's.
        `halo`: K2's halo form, (the bytes it reads from its halo rows, their
        live slots, whose codes it computes); its launches count under
        rebucket_halo."""
        out_k, out_t = run_kernel(), run_twin()
        if isinstance(out_k[2], tuple):
            if kernel == "rebucket":  # planes: (D, P, ny, nx)
                stacked = torch.cat([v if v.ndim == 4 else v[None] for v in out_k[2]])
            else:  # slots: (ny, nx, P, D)
                stacked = torch.cat([v if v.ndim == 4 else v[..., None] for v in out_k[2]],
                                    dim=-1)
            out_k = (out_k[0], out_k[1], stacked, out_k[3])
        torch.cuda.synchronize()
        equal = bit_equal(out_k, out_t)
        drops = int(out_k[3])
        log(f"phase 3 kernels: {kernel}[{label}] bit-equal {equal} drops {drops} "
            f"live {int(out_k[1].sum())}")
        if not equal:
            raise RuntimeError(f"{kernel}[{label}] is not bit-equal to its twin")
        if overflow and drops == 0:
            raise RuntimeError(f"{kernel}[{label}] forced no drops")
        if not overflow:
            if drops != 0:
                raise RuntimeError(f"{kernel}[{label}] dropped particles")
            ms, plain_ms = graph_ms(run_kernel), event_ms(run_twin)
            log(f"phase 3 kernels: {kernel}[{label}] kernel {ms:.5f} ms twin "
                f"{plain_ms:.4f} ms")
            extra_bytes, extra_slots = (0, 0) if halo is None else halo
            n_ops = OPS_PER_SLOT_REBUCKET * (int(inputs[1].sum()) + extra_slots)
            n_bytes = rebucket_bytes(*inputs, out_k) + extra_bytes
            bound_ms, bound_by = bound(n_bytes, n_ops)
            bound_line(f"{kernel}[{label}]", bound_ms, bound_by,
                       f"{n_bytes} bytes, {n_ops} float32 operations", ms)
            counter = kernel if halo is None else kernel + HALO
            self.add(name or kernel, kernel, 0.0, ms, plain_ms, bound_ms, bound_by,
                     counter=counter, paths=paths, source=counter)

    def require_nonzero(self, names):
        """Each of `names` (a form, or a form's call by its label) produced a
        nonzero live output."""
        idle = set(names) - self.nonzero
        if idle:
            raise RuntimeError(f"pair forms never produced a nonzero live output: {idle}")


def moving_state(kind, device, steps):
    """A 100k state in motion: init_carry + `steps` steps."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    world = double_dam_break(100_000)
    solver, boundary = bench_solver(kind, world, device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, steps)
    torch.cuda.synchronize()
    return solver, boundary, carry


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("phase 1 environment: FAILED, torch.cuda.is_available() is false")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
    nvcc_version = (nvcc.stdout.strip().splitlines() or ["nvcc not found"])[-1]
    log(f"phase 1 environment: {gpu_line()} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {nvcc_version} | "
        f"devices {torch.cuda.device_count()}")


def phase_build():
    """The CUDA kernels (nvcc), then the app's native host library (g++:
    native/render.cpp, native/recorder.cpp)."""
    from yasph2d_tpu_torch import native
    from yasph2d_tpu_torch.ops import cuda_build

    fresh = not cuda_build.library_path().exists()
    t0 = time.perf_counter()
    path = cuda_build.build()
    t_build = time.perf_counter() - t0
    cuda_build.library()
    t1 = time.perf_counter()
    host_path = native.build()
    native.load_render()
    log(f"phase 2 build: {path.name} {'nvcc' if fresh else 'already built,'} "
        f"{t_build:.2f} s, load {t1 - t0 - t_build:.2f} s; "
        f"{host_path.name} (g++) {time.perf_counter() - t1:.2f} s")


def physical(solver):
    """`solver` with BASELINE config 3's viscosity (PhysicalViscosityModel, mu =
    0.01, reference main.rs:95-96): its viscosity forms are the *_phys ones."""
    from yasph2d_tpu_torch import PhysicalViscosityModel

    return dataclasses.replace(solver, viscosity_model=PhysicalViscosityModel(
        solver.properties.smoothing_length, fluid_viscosity=0.01))


def k1_pairs(q, s):
    """A K1 call's geometry in the slot layout for its operation count, and
    its rebase cell in bf16 mode."""
    return (*plane_pairs(q, s), q.rebase_cell)


# A pair call to check: (label suffix, form, source geometry, keyword
# operands, the solver's PairConsts, mode). The builders below list a step's
# calls on a state: `solver`'s forms with `mode`, its viscosity form with
# `visc_mode`, and, with `phys` (the same solver with physical viscosity),
# also that solver's viscosity form on the same operands, TIME (phase 3: its
# record is taken on the config paths, the shapes it launches at). Each
# returns (query geometry, live query slots, calls).


def check_k1_calls(rec: Records, geom, live, calls, variant="", size="", paths=None,
                   where=""):
    """K1 calls with `geom` as the query side; arguments as `check_pair`."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr

    for suffix, form, src, kw, c, mode in calls:
        rec.check_pair(
            "pair_reduce", form.name + suffix, form,
            lambda: pr.pair_reduce(form, geom, src, c, **kw),
            lambda: pr.pair_reduce_ref(form.term_fn, form.n_out, geom, src, c.radius_sq,
                                       post_fn=form.post_fn, n_acc=form.n_acc, **kw),
            live, 0, role_tensors(geom.pos, src.pos, kw), [geom.mask, src.mask],
            k1_pairs(geom, src), c.radius_sq, variant, size, paths, mode, where)


def check_slot_calls(rec: Records, kernel, pos, mask, calls, paths=None, where=""):
    """K3 or K5 calls on one padded state against their twins; a call with a
    `rebase` is K5's bf16 math mode (records `<form>_bf16`)."""
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp

    run, ref = {"sm_pair_reduce": (smp.sm_pair_reduce, smp.sm_pair_reduce_ref),
                "tile_pair_reduce": (tpp.pallas_pair_reduce,
                                     tpp.pallas_pair_reduce_ref)}[kernel]
    for suffix, form, (s_pos, s_mask), kw, c, mode in calls:
        rebase = kw.get("rebase")
        rec.check_pair(
            kernel, form.name + suffix, form,
            lambda: run(form, pos, mask, s_pos, s_mask, c, **kw),
            lambda: ref(form.term_fn, form.n_out, pos, mask, s_pos, s_mask,
                        c.radius_sq, **kw),
            mask, -1, role_tensors(pos, s_pos, kw), [mask, s_mask],
            (pos, mask, s_pos, s_mask, None, rebase), c.radius_sq,
            "" if rebase is None else BF16, paths=paths, mode=mode, where=where)


def slot_kw(solver, kw: dict) -> dict:
    """A padded step's K3 / K5 call operands `kw`, with the solver's rebase
    on a bf16 grid (K5's bf16 math mode)."""
    from yasph2d_tpu_torch.ops.pallas_pair import rebase_of

    rebase = rebase_of(solver.grid)
    return kw if rebase is None else dict(kw, rebase=rebase)


def phase_kernels_dfsph(device, rec: Records, kind="dfsph_plane"):
    """K1's six DFSPH forms, visc_gravity_phys and the unfused step's visc,
    div, corr and visc_phys on the plane state of `kind` (f32 or bf16
    operands; the unfused forms are records in f32, the path they launch on,
    and checked only in bf16) and, in f32, the re-bucket K2."""
    solver, boundary, carry = moving_state(kind, device, CONTACT_STEPS)
    variant = "_bf16" if solver.grid.pair_dtype == "bfloat16" else ""
    geom, live, calls = dfsph_plane_calls(solver, boundary, carry, phys=physical(solver),
                                          unfused_mode=CHECK if variant else RECORD)
    check_k1_calls(rec, geom, live, calls, variant)
    rec.require_nonzero([f"pair_reduce_{n}{variant}" for n in DFSPH_PHYS_FORMS + DFSPH_FORMS]
                        + [f"pair_reduce_ctx[boundary]{variant}"]
                        + [f"pair_reduce_{n}{variant}" for n in DFSPH_UNFUSED_FORMS[1:]])
    if not variant:  # K2 does not change with the operand mode
        check_plane_rebucket(device, rec, solver, carry)


def phase_kernels_1m(device, rec: Records):
    """K1's six DFSPH bf16 forms and K2 on the 1M state of the roofline path
    (tools.roofline.settle: ROOFLINE's particles and settle steps, bf16),
    where the device sets the pace."""
    from yasph2d_tpu_torch.tools.roofline import settle

    t0 = time.perf_counter()
    _, solver, boundary, carry, _ = settle(int(ROOFLINE[0]), int(ROOFLINE[1]), "bfloat16",
                                           device)
    torch.cuda.synchronize()
    log(f"phase 3 kernels: 1M bf16 state settled in {time.perf_counter() - t0:.2f} s, "
        f"grid {solver.grid.nx}x{solver.grid.ny}, {int(carry.ctx.mask.sum())} live")
    geom, live, calls = dfsph_plane_calls(solver, boundary, carry)
    check_k1_calls(rec, geom, live, calls, "_bf16", SIZE_1M, {"roofline"})
    rec.require_nonzero([f"pair_reduce_{n}_bf16{SIZE_1M}" for n in DFSPH_FORMS]
                        + [f"pair_reduce_ctx[boundary]_bf16{SIZE_1M}"])
    check_plane_rebucket(device, rec, solver, carry, SIZE_1M, {"roofline"})


def dfsph_plane_calls(solver, boundary, carry, mode=RECORD, visc_mode=RECORD, phys=None,
                      unfused_mode=None):
    """The DFSPH plane step's K1 calls on a DFSPH plane state (the operand
    mode is the solver's); the ctx instantiation also fluid -> fluid, where
    every live slot has neighbours (the unfused step's ctx pass). With
    `unfused_mode`, also the unfused step's no-epilogue forms visc, div and
    corr on the same operands with that mode, and with `phys` visc_phys,
    TIME."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr

    ctx = carry.ctx
    geom = ctx.geom
    device = ctx.mask.device
    dt = float(carry.time.dt)
    m = np.float32(solver.properties.particle_mass)
    scale = float((np.float32(1.0) / np.float32(dt)) * m)
    f, c = solver._forms, solver._consts
    stat = pr.pair_reduce(f.ctx, geom, boundary.geom, c)
    # most of the fluid is still a barely compressed lattice whose slots have
    # fewer than the 9 neighbours the divergence guard asks for: seeded
    # velocity, stiffness and neighbour-count noise makes the loop forms do
    # real work on every live slot
    rng = np.random.default_rng(0)
    nt = torch.as_tensor(
        np.floor(rng.uniform(0.0, 18.0, tuple(ctx.neighbor_total.shape))).astype(np.float32),
        device=device)
    v = carry.v + torch.as_tensor(
        rng.normal(0.0, 0.5, tuple(carry.v.shape)).astype(np.float32), device=device)
    k = torch.as_tensor(
        rng.normal(0.0, 50.0, tuple(carry.kappa.shape)).astype(np.float32), device=device)
    visc_kw = dict(q_vals=(v,), s_vals=(v, ctx.densities), scalars=(dt,))
    calls = [
        ("[boundary]", f.ctx, boundary.geom, {}, c, mode),
        ("[fluid->fluid]", f.ctx, geom, {}, c, mode),
        ("", f.ctx_post, geom, dict(post_planes=(stat,)), c, mode),
        ("", f.visc_gravity, geom, visc_kw, c, visc_mode),
        ("", f.err_ki, geom, dict(
            q_vals=(v,), s_vals=(v,), scalars=(dt,),
            post_planes=(v, ctx.sum_grad_stat, ctx.densities, ctx.alpha)), c, mode),
        ("", f.delta_ki, geom, dict(
            q_vals=(v,), s_vals=(v,),
            post_planes=(v, ctx.sum_grad_stat, nt, ctx.alpha)), c, mode),
        ("", f.corr_v, geom, dict(
            q_vals=(k,), s_vals=(k,), scalars=(scale,),
            post_planes=(v, k, ctx.sum_grad_stat)), c, mode),
    ]
    if phys is not None:
        calls.append(("", phys._forms.visc_gravity, geom, visc_kw, phys._consts, TIME))
    if unfused_mode is not None:
        calls += [("", f.visc, geom, visc_kw, c, unfused_mode),
                  ("", f.div, geom, dict(q_vals=(v,), s_vals=(v,)), c, unfused_mode),
                  ("", f.corr, geom, dict(q_vals=(k,), s_vals=(k,)), c, unfused_mode)]
        if phys is not None:
            calls.append(("", phys._forms.visc, geom, visc_kw, phys._consts,
                          TIME if unfused_mode == RECORD else CHECK))
    return geom, ctx.mask, calls


def check_plane_rebucket(device, rec: Records, solver, carry, size="", paths=None, where=""):
    """K2 with the DFSPH plane step's payload as the step calls it: the
    step's own advection, and a forced overflow in which every particle of an
    odd cell column moves one cell left; `where` names the state in the log."""
    from yasph2d_tpu_torch.ops import rebucket as rb

    grid, ctx = solver.grid, carry.ctx
    pos = ctx.pos + carry.v * float(carry.time.dt)
    parts = (carry.v, carry.kappa, carry.stiff)
    extra = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]], dim=0)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[0] -= odd * grid.cell_size
    for label, p in (("advect", pos), ("overflow", crowded)):
        rec.check_rebucket("rebucket", label + size + where,
                           lambda: rb.rebucket_planes(p, ctx.mask, parts, grid),
                           lambda: rb.rebucket_ref(p, ctx.mask, extra, grid),
                           overflow=label == "overflow", inputs=[p, ctx.mask, extra],
                           name="rebucket" + size, paths=paths)


def noise(t, scale, rng):
    return torch.as_tensor(rng.normal(0.0, scale, tuple(t.shape)).astype(np.float32),
                           device=t.device)


def wcsph_operands(solver, live, v_live, v, dens, rng):
    """Forces-pass operands of a WCSPH state: the barely compressed early state
    has rho = rho0 and p = 0 everywhere, so seeded density (up) and velocity
    noise on live slots gives the pressure and viscosity terms real work."""
    from yasph2d_tpu_torch.models.wcsph import tait_pressure

    rho0 = solver.properties.fluid_density
    dens = torch.where(live, dens + noise(dens, 0.05 * rho0, rng).abs(), dens)
    v = torch.where(v_live, v + noise(v, 0.5, rng), v)
    return tait_pressure(solver.stiffness, rho0, dens), dens, v


def wcsph_calls(solver, fluid, walls, operands, dt, mode, visc_mode, phys):
    """The WCSPH step's calls against the `fluid` and `walls` sources, the
    forces pass on `operands` (pres, dens, v); the fluid -> boundary pass
    sums nothing before the columns reach the walls, so its instantiation
    also runs fluid -> fluid."""
    f, c = solver._forms, solver._consts
    forces_kw = dict(q_vals=operands, s_vals=operands, scalars=(dt,))
    calls = [
        ("", f.density, fluid, {}, c, mode),
        ("", f.stat, walls, {}, c, mode),
        ("[fluid->fluid]", f.stat, fluid, {}, c, mode),
        ("", f.forces, fluid, forces_kw, c, visc_mode),
    ]
    if phys is not None:
        calls.append(("", phys._forms.forces, fluid, forces_kw, phys._consts, TIME))
    return calls


def wcsph_slot_calls(solver, boundary, carry, rng, mode=RECORD, visc_mode=RECORD, phys=None):
    """The WCSPH padded step's K3 or K5 calls on a padded state."""
    pos, mask = carry.pos_pad, carry.mask
    operands = wcsph_operands(solver, mask, mask[..., None], carry.v_pad, carry.dens_pad, rng)
    calls = wcsph_calls(solver, (pos, mask), (boundary.pos_pad, boundary.mask), operands,
                        float(carry.time.dt), mode, visc_mode, phys)
    return (pos, mask), mask, [(sfx, form, src, slot_kw(solver, kw), c, m)
                               for sfx, form, src, kw, c, m in calls]


def padded_wcsph(solver, carry):
    """A sorted WCSPH carry in the padded carry's slot layout (pos_pad, mask,
    v_pad, dens_pad, time), as its step pads it, for its pair calls."""
    from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedCarry
    from yasph2d_tpu_torch.ops.dense_grid import build_slot_grid, pad_to_slots

    g, p = solver.grid, carry.particles
    (pos, vel, dens), keys = solver._sort((p.positions, p.velocities, p.densities),
                                          p.positions, p.alive)
    slots = build_slot_grid(keys, g)
    return WCSPHPaddedCarry(pos_pad=pad_to_slots(pos, slots, g),
                            v_pad=pad_to_slots(vel, slots, g),
                            accel_pad=None, dens_pad=pad_to_slots(dens, slots, g),
                            mask=slots.slot_mask.reshape(g.ny, g.nx, g.occupancy),
                            time=carry.time)


def wcsph_plane_calls(solver, boundary, carry, rng, mode=RECORD, visc_mode=RECORD, phys=None):
    """The WCSPH plane step's K1 calls on a plane state (the operand mode is
    the solver's)."""
    from yasph2d_tpu_torch.ops.planes import plane_geom

    geom = plane_geom(carry.pos, carry.mask, solver.grid)
    operands = wcsph_operands(solver, carry.mask, carry.mask[None], carry.v, carry.dens, rng)
    return geom, carry.mask, wcsph_calls(solver, geom, boundary.geom, operands,
                                         float(carry.time.dt), mode, visc_mode, phys)


def phase_kernels_wcsph(device, rec: Records):
    from yasph2d_tpu_torch.ops import sm_rebucket as smr

    rng = np.random.default_rng(1)

    # K3 and K4 (D = 2) on the padded state
    solver, boundary, carry = moving_state("wcsph_padded", device, WARMUP_STEPS)
    grid = solver.grid
    dt = float(carry.time.dt)
    (pos, mask), _, calls = wcsph_slot_calls(solver, boundary, carry, rng,
                                             phys=physical(solver))
    check_slot_calls(rec, "sm_pair_reduce", pos, mask, calls)
    rec.require_nonzero([f"sm_pair_reduce_{n}" for n in WCSPH_FORMS + WCSPH_PHYS_FORMS])
    adv = pos + carry.v_pad * dt
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = adv.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    for label, p in (("advect", adv), ("overflow", crowded)):
        rec.check_rebucket("sm_rebucket", label,
                           lambda: smr.sm_rebucket_parts(p, mask, (carry.v_pad,), grid),
                           lambda: smr.sm_rebucket_ref(p, mask, carry.v_pad, grid),
                           overflow=label == "overflow", inputs=[p, mask, carry.v_pad],
                           paths={"wcsph_padded", "wcsph_padded_k5"})

    # K5's WCSPH forms on the padded states of the K5 route, f32 and bf16 math
    for kind, variant in (("wcsph_padded_k5", ""), ("wcsph_padded_k5_bf16", BF16)):
        solver, boundary, carry = moving_state(kind, device, WARMUP_STEPS)
        (pos, mask), _, calls = wcsph_slot_calls(solver, boundary, carry, rng,
                                                 phys=physical(solver))
        check_slot_calls(rec, "tile_pair_reduce", pos, mask, calls)
        rec.require_nonzero([f"tile_pair_reduce_{n}{variant}"
                             for n in WCSPH_FORMS + WCSPH_PHYS_FORMS])

    phase_kernels_wcsph_plane(device, rec, "wcsph_plane", rng)


def phase_kernels_wcsph_plane(device, rec: Records, kind, rng):
    """K1's WCSPH forms and wcsph_forces_phys on the plane state of `kind`
    (f32 or bf16 operands) and, in f32, K2 with the velocity payload."""
    from yasph2d_tpu_torch.ops import rebucket as rb

    solver, boundary, carry = moving_state(kind, device, WARMUP_STEPS)
    variant = "_bf16" if solver.grid.pair_dtype == "bfloat16" else ""
    geom, live, calls = wcsph_plane_calls(solver, boundary, carry, rng, phys=physical(solver))
    check_k1_calls(rec, geom, live, calls, variant)
    rec.require_nonzero([f"pair_reduce_{n}{variant}" for n in WCSPH_FORMS + WCSPH_PHYS_FORMS])
    if variant:
        return  # K2 does not change with the operand mode
    adv = carry.pos + carry.v * float(carry.time.dt)
    rec.check_rebucket("rebucket", "wcsph advect",
                       lambda: rb.rebucket(adv, carry.mask, carry.v, solver.grid),
                       lambda: rb.rebucket_ref(adv, carry.mask, carry.v, solver.grid),
                       overflow=False, inputs=[adv, carry.mask, carry.v])


def dfsph_slot_calls(solver, boundary, carry, rng, mode=RECORD, visc_mode=RECORD, phys=None):
    """The DFSPH padded step's K3 or K5 calls on a padded state, with seeded
    velocity and stiffness noise (most of the lattice barely compresses
    yet); the boundary pass's instantiation (dfsph_stat on K3, dfsph_ctx on
    K5) also on the many more fluid -> fluid pairs."""
    f, c, ctx = solver._padded_forms, solver._consts, carry.ctx
    dt = float(carry.time.dt)
    mask = ctx.mask
    v = torch.where(mask[..., None], carry.v_pad + noise(carry.v_pad, 0.5, rng),
                    carry.v_pad)
    k = torch.where(mask, noise(carry.kappa_pad, 50.0, rng), 0.0)
    fluid = (ctx.pos_pad, mask)
    walls = (boundary.pos_pad, boundary.mask)
    visc_kw = dict(q_vals=(v,), s_vals=(v, ctx.densities_pad), scalars=(dt,))
    calls = [
        ("", f.ctx, fluid, {}, c, mode),
        ("[boundary]", f.stat, walls, {}, c, mode),
        ("[fluid->fluid]", f.stat, fluid, {}, c, mode),
        ("", f.div, fluid, dict(q_vals=(v,), s_vals=(v,)), c, mode),
        ("", f.corr, fluid, dict(q_vals=(k,), s_vals=(k,)), c, mode),
        ("", f.visc, fluid, visc_kw, c, visc_mode),
    ]
    if phys is not None:
        calls.append(("", phys._padded_forms.visc, fluid, visc_kw, phys._consts, TIME))
    return fluid, mask, [(sfx, form, src, slot_kw(solver, kw), cc, m)
                         for sfx, form, src, kw, cc, m in calls]


def check_padded_rebucket(device, rec: Records, solver, carry, where=""):
    """K4 with the DFSPH padded step's payload (D = 4) as the step calls it:
    the step's own advection, and a forced overflow in which every particle
    of an odd cell column moves one cell left; `where` names the state in the
    log."""
    from yasph2d_tpu_torch.ops import sm_rebucket as smr

    ctx, grid = carry.ctx, solver.grid
    adv = ctx.pos_pad + carry.v_pad * float(carry.time.dt)
    parts = (carry.v_pad, carry.kappa_pad, carry.stiff_pad)
    extra = torch.cat([carry.v_pad, carry.kappa_pad[..., None],
                       carry.stiff_pad[..., None]], dim=-1)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = adv.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    for label, p in (("D=4 advect", adv), ("D=4 overflow", crowded)):
        rec.check_rebucket("sm_rebucket", label + where,
                           lambda: smr.sm_rebucket_parts(p, ctx.mask, parts, grid),
                           lambda: smr.sm_rebucket_ref(p, ctx.mask, extra, grid),
                           overflow=label.endswith("overflow"),
                           inputs=[p, ctx.mask, extra], name="sm_rebucket_d4",
                           paths={"dfsph_padded", "dfsph_padded_k5"})


def phase_kernels_dfsph_padded(device, rec: Records):
    rng = np.random.default_rng(2)

    # K3's five DFSPH forms and K4 (D = 4) on the padded state
    solver, boundary, carry = moving_state("dfsph_padded", device, CONTACT_STEPS)
    (pos, mask), _, calls = dfsph_slot_calls(solver, boundary, carry, rng,
                                             phys=physical(solver))
    check_slot_calls(rec, "sm_pair_reduce", pos, mask, calls)
    rec.require_nonzero([f"sm_pair_reduce_{n}" for n in DFSPH_SM_FORMS + DFSPH_SM_PHYS_FORMS]
                        + ["sm_pair_reduce_dfsph_stat[boundary]"])
    check_padded_rebucket(device, rec, solver, carry)

    # K5's four DFSPH forms on the padded states of the K5 route, f32 and bf16
    for kind, variant in (("dfsph_padded_k5", ""), ("dfsph_padded_k5_bf16", BF16)):
        solver, boundary, carry = moving_state(kind, device, CONTACT_STEPS)
        (pos, mask), _, calls = dfsph_slot_calls(solver, boundary, carry, rng,
                                                 phys=physical(solver))
        check_slot_calls(rec, "tile_pair_reduce", pos, mask, calls)
        rec.require_nonzero([f"tile_pair_reduce_{n}{variant}" for n in DFSPH_TILE_FORMS
                             + DFSPH_TILE_PHYS_FORMS]
                            + [f"tile_pair_reduce_dfsph_ctx[boundary]{variant}"])


def phase_kernels_probes(device, rec: Records):
    """K6 (fma x4, x8, mix x8) and K7 against their twins at the TPU probes'
    shapes; K7 beside K1's ctx form on the same inputs. K6 is checked on the
    TPU probe's constant input and on a seeded one spread across the select's
    0.5, which a kernel that drops the select or reads the wrong element
    fails; it is timed on the TPU probe's."""
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc
    from yasph2d_tpu_torch.tools import vpu_probe as vp

    x = vp.probe_input(device)
    inputs = {"0.999": x, "spread": vp.spread_input(device)}
    n = x.numel()
    # the bound: FMA chains by FP32 operations at the data-sheet rate; the mix
    # by its SASS (one FSETP, one FSEL and one FADD a step) at each pipe's rate
    steps = n * vp.K_OPS
    mix_counts = {"FADD": steps, "FSETP": steps, "FSEL": steps}
    probes = [(f"vpu_probe_fma{c}", "vpu_probe_fma", (lambda a, c=c: vp.fma_probe(a, c)),
               (lambda a, c=c: vp.fma_probe_ref(a, c)), vp.fma_ops(n, c),
               bound(nbytes(x) * 2, vp.fma_ops(n, c)) + ("FP32 operations",))
              for c in vp.FMA_CHAINS]
    mix_ms, mix_pipe = instruction_bound(mix_counts)
    probes.append((f"vpu_probe_mix{vp.MIX_CHAINS}", "vpu_probe_mix", vp.mix_probe,
                   vp.mix_probe_ref, vp.mix_ops(n),
                   (mix_ms, "operations", f"{mix_pipe}, SASS instructions {mix_counts}")))
    for name, replaces, run_kernel, run_twin, n_ops, (bound_ms, bound_by, what) in probes:
        errs = []
        for label, a in inputs.items():
            out_k, out_t = run_kernel(a), run_twin(a)
            torch.cuda.synchronize()
            errs.append(float((out_k - out_t).abs().max()))
            # the FMA rounds once per step; the twin rounds the exact float64
            # product plus 1e-7 to float64, then to f32 (an ulp off, rarely)
            ok = bool(torch.isfinite(out_k).all()) and bool(
                torch.allclose(out_k, out_t, rtol=1e-5, atol=0.0))
            log(f"phase 3 kernels: {name}[{label}] max_abs_err {errs[-1]!r} (rtol 1e-5) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise RuntimeError(f"{name}[{label}] disagrees with its twin "
                                   f"(max_abs_err {errs[-1]})")
        ms, plain_ms = graph_ms(lambda: run_kernel(x)), event_ms(lambda: run_twin(x))
        log(f"phase 3 kernels: {name} kernel {ms:.5f} ms twin {plain_ms:.4f} ms, "
            f"{n_ops / (ms * 1e-3) / 1e12:.2f} T operations/s")
        bound_line(name, bound_ms, bound_by, what, ms)
        rec.add(name, "vpu_probe", max(errs), ms, plain_ms, bound_ms, bound_by,
                paths={"vpu_probe", "roofline"}, replaces=replaces)

    d = pc.GPU_SHAPE
    pos, mask = pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"])
    q = pc.probe_planes(pos, mask, device)
    run_kernel = lambda: pc.ctx_pass(q, q, d["h"], d["m"])  # noqa: E731
    run_twin = lambda: pc.ctx_pass_ref(q, q, d["h"], d["m"])  # noqa: E731
    k1 = pc.k1_ctx_call(q, q, d["h"], d["m"])
    out_k, out_t, out_k1 = run_kernel(), run_twin(), k1()
    torch.cuda.synchronize()
    live = q[2] > 0.0
    errs, _ = pair_error(out_k, out_t, live, 0)
    ok = bit_equal([out_k], [out_t])
    beside = pc.agree(out_k, out_k1)
    log(f"phase 3 kernels: probe_ctx max_abs_err {max(errs)!r} per component {errs!r} "
        f"{'ok' if ok else 'MISMATCH'} (bit-equal required); agrees with K1 ctx "
        f"(rtol 1e-4) {beside}")
    if not (ok and beside):
        raise RuntimeError(f"probe_ctx disagrees with its twin or with K1 ctx ({errs})")
    ms, plain_ms, k1_ms = graph_ms(run_kernel), event_ms(run_twin), graph_ms(k1)
    pos_planes = q[:2]  # read as query and as source: each slot counted once
    slot_q, slot_m = pos_planes.permute(2, 3, 1, 0), live.permute(1, 2, 0)
    cand, valid = pair_counts(slot_q, slot_m, slot_q, slot_m, d["h"] * d["h"])
    log(f"phase 3 kernels: probe_ctx kernel {ms:.5f} ms twin {plain_ms:.4f} ms, K1 ctx "
        f"on the same inputs {k1_ms:.5f} ms ({k1_ms / ms:.2f}x K7), planes "
        f"{tuple(q.shape)}, {cand} live candidates, {valid} valid pairs")
    n_bytes = pair_bytes((pos_planes,), (pos_planes,), [q[2]], [out_k], slot_m, slot_m)
    n_ops = 5 * cand + OPS_PER_PAIR["probe_ctx"] * valid
    bound_ms, bound_by = bound(n_bytes, n_ops)
    bound_line("probe_ctx", bound_ms, bound_by,
               f"{n_bytes} bytes, {n_ops} float32 operations", ms)
    rec.add("probe_ctx", "probe_ctx", max(errs), ms, plain_ms, bound_ms, bound_by,
            paths={"probe_ctx"})


def slot_space(rng, grid, pp, fill, dead_rho, device):
    """A slot-layout space of `pp` slots a cell on `grid`: random liveness,
    live positions near their own cell (dead ones 0), values v (.., 2), k,
    rho (dead slots hold `dead_rho`) and pres, all on `device`."""
    ny, nx, h = grid.ny, grid.nx, grid.cell_size
    mask = rng.random((ny, nx, pp)) < fill
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
    pos = np.where(mask[..., None], cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h,
                   0.0)
    f = lambda *tail: rng.random((ny, nx, pp) + tail)  # noqa: E731
    vals = dict(v=f(2) * 2 - 1, k=f() * 50 - 25, rho=np.where(mask, 100 + 30 * f(), dead_rho),
                pres=f() * 500)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)  # noqa: E731
    return (t(pos), torch.as_tensor(mask).to(device)), {k: t(v) for k, v in vals.items()}


def phase_kernels_deep(device):
    """K1 (fifteen forms, f32 and bf16 operands), K3 (ten forms) and K7 with a
    source space of DEEP_PS slots, cells of more than 32 live ones (two live
    words a cell), on a ragged grid of the 3k scene's cell size (query
    spaces of P 7, K7 P 12, 60% live; sources 90% live, dead rho NaN),
    bit-equal to their twins. Correctness only: not timed, no record."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.ops.planes import PlaneGeom, plane_geom, to_planes
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc

    world = double_dam_break(3_000)
    sv = {kind: bench_solver(kind, world, device)[0] for kind in (
        "dfsph_plane", "wcsph_plane", "dfsph_padded", "wcsph_padded")}
    phys = {kind: physical(solver) for kind, solver in sv.items()}
    grid = dataclasses.replace(sv["dfsph_plane"].grid, ny=61, nx=97)
    rng = np.random.default_rng(9)
    (pos, mask), qv = slot_space(rng, grid, 7, 0.6, 0.0, device)
    (spos, smask), dv = slot_space(rng, grid, DEEP_PS, 0.9, float("nan"), device)
    most = int(smask.sum(-1).max())
    dt = 1.0 / 2700.0
    results = {}

    def record(name, out, ref):
        torch.cuda.synchronize()
        equal = bit_equal([out], [ref])
        results[name] = equal
        if not equal:
            raise RuntimeError(f"{name} at Ps = {DEEP_PS} is not bit-equal to its twin "
                               f"(max |diff| {float((out - ref).abs().nan_to_num().max())!r})")

    # K3: the slot layout in place; (form, keyword operands, PairConsts)
    d, w = sv["dfsph_padded"], sv["wcsph_padded"]
    dphys, wphys = phys["dfsph_padded"], phys["wcsph_padded"]
    f, fw = d._padded_forms, w._forms
    wq, ws = (qv["pres"], qv["rho"], qv["v"]), (dv["pres"], dv["rho"], dv["v"])
    visc_kw = dict(q_vals=(qv["v"],), s_vals=(dv["v"], dv["rho"]), scalars=(dt,))
    forces_kw = dict(q_vals=wq, s_vals=ws, scalars=(dt,))
    k3 = [(f.ctx, {}), (f.stat, {}), (f.div, dict(q_vals=(qv["v"],), s_vals=(dv["v"],))),
          (f.corr, dict(q_vals=(qv["k"],), s_vals=(dv["k"],))), (f.visc, visc_kw)]
    k3 = [(form, kw, d._consts) for form, kw in k3] + [
        (fw.density, {}, w._consts), (fw.stat, {}, w._consts),
        (fw.forces, forces_kw, w._consts),
        (dphys._padded_forms.visc, visc_kw, dphys._consts),
        (wphys._forms.forces, forces_kw, wphys._consts)]
    for form, kw, c in k3:
        record(f"sm_pair_reduce_{form.name}",
               smp.sm_pair_reduce(form, pos, mask, spos, smask, c, **kw),
               smp.sm_pair_reduce_ref(form.term_fn, form.n_out, pos, mask, spos, smask,
                                      c.radius_sq, **kw))
    # K1: the same spaces as planes, f32 and bf16 operands
    planes = lambda a: to_planes(a).contiguous()  # noqa: E731
    q32, s32 = PlaneGeom(planes(pos), planes(mask)), PlaneGeom(planes(spos), planes(smask))
    qp, dp = ({k: planes(v) for k, v in d.items()} for d in (qv, dv))
    shape = q32.mask.shape
    sgs, dens = qp["v"] * 20.0, qp["rho"] * 0.05 + 95.0
    alpha = torch.full(shape, 1e-3, device=device)
    nt = torch.floor(qp["k"].abs() * 0.7)
    d, w = sv["dfsph_plane"], sv["wcsph_plane"]
    dphys, wphys = phys["dfsph_plane"], phys["wcsph_plane"]
    fd, fw = d._forms, w._forms
    for bf16 in (False, True):
        g = dataclasses.replace(grid, pair_dtype="bfloat16")
        q, src = (plane_geom(q32.pos, q32.mask, g), plane_geom(s32.pos, s32.mask, g)) \
            if bf16 else (q32, s32)
        stat = pr.pair_reduce_ref(fd.ctx.term_fn, 5, q, src, grid.radius_sq)
        visc_kw = dict(q_vals=(qp["v"],), s_vals=(dp["v"], dp["rho"]), scalars=(dt,))
        forces_kw = dict(q_vals=(qp["pres"], qp["rho"], qp["v"]),
                         s_vals=(dp["pres"], dp["rho"], dp["v"]), scalars=(dt,))
        k1 = [(fd.ctx, {}), (fd.ctx_post, dict(post_planes=(stat,))),
              (fd.visc_gravity, visc_kw),
              (fd.err_ki, dict(q_vals=(qp["v"],), s_vals=(dp["v"],), scalars=(dt,),
                               post_planes=(qp["v"], sgs, dens, alpha))),
              (fd.delta_ki, dict(q_vals=(qp["v"],), s_vals=(dp["v"],),
                                 post_planes=(qp["v"], sgs, nt, alpha))),
              (fd.corr_v, dict(q_vals=(qp["k"],), s_vals=(dp["k"],), scalars=(1234.5,),
                               post_planes=(qp["v"], qp["k"], sgs))),
              (fd.visc, visc_kw), (fd.div, dict(q_vals=(qp["v"],), s_vals=(dp["v"],))),
              (fd.corr, dict(q_vals=(qp["k"],), s_vals=(dp["k"],)))]
        k1 = [(form, kw, d._consts) for form, kw in k1] + [
            (fw.density, {}, w._consts), (fw.stat, {}, w._consts),
            (fw.forces, forces_kw, w._consts),
            (dphys._forms.visc_gravity, visc_kw, dphys._consts),
            (wphys._forms.forces, forces_kw, wphys._consts),
            (dphys._forms.visc, visc_kw, dphys._consts)]
        for form, kw, c in k1:
            record(f"pair_reduce_{form.name}{'_bf16' if bf16 else ''}",
                   pr.pair_reduce(form, q, src, c, **kw),
                   pr.pair_reduce_ref(form.term_fn, form.n_out, q, src, c.radius_sq,
                                      post_fn=form.post_fn, n_acc=form.n_acc, **kw))
    # K7: the probe's planes, P 12 against Ps = DEEP_PS
    d = pc.CHECK_SHAPE
    pq = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], 12, d["h"]), device)
    ps_ = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], DEEP_PS, d["h"], seed=1), device)
    record("probe_ctx", pc.ctx_pass(pq, ps_, d["h"], d["m"]),
           pc.ctx_pass_ref(pq, ps_, d["h"], d["m"]))
    log(f"phase 3 kernels: Ps = {DEEP_PS} (at most {most} live slots a cell), grid "
        f"{grid.nx}x{grid.ny}: {len(results)} launchers bit-equal to their twins: "
        f"{sorted(results)}")


def live_rows(state):
    """(x, y, density) of the live particles, on the CPU, in slot order."""
    alive = state.alive
    return torch.cat([state.positions, state.densities[:, None]], dim=1)[alive].cpu()


def matched_rows(a, b):
    """The live rows of `b` reordered to match `a`'s, each row of `a` paired
    with the row of `b` nearest in position; None when that is not one to
    one. Slot order can differ between two runs and any sort key can tie
    (equal densities at rest, equal x in a falling column); two particles are
    never within 1e-5 of each other."""
    if a.shape != b.shape:
        return None
    j = torch.cdist(a[:, :2].double(), b[:, :2].double()).argmin(1)
    return b[j] if torch.unique(j).numel() == j.numel() else None


def to_device(tree, device):
    """A carry or boundary (nested named tuples of tensors) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def run_steps(solver, carry, boundary, n):
    """(carry, [(density its, divergence its, drops) per step]) after n steps."""
    counts = []
    for _ in range(n):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    return carry, counts


def phase_small_reference(device):
    """Kernels on the GPU against the twins on the CPU on a 3k scene: 5 steps
    from rest for every path, with XSPH and with physical viscosity (the
    *_phys forms), and for the DFSPH paths 5 more from the GPU's state in
    wall contact, copied to the CPU, with either viscosity."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    sides = {"gpu": device, "cpu": torch.device("cpu")}
    # the table and sorted paths with XSPH only: their physical forms are
    # the padded paths' (and the config paths run them at 100k)
    for kind, phys in [(k, p) for k in SOLVER_PATHS for p in (False, True)
                       if not (p and k in NO_REBUCKET)]:
        solvers = {side: bench_solver(kind, double_dam_break(3_000), dev)
                   for side, dev in sides.items()}
        if phys:
            solvers = {side: (physical(s), b) for side, (s, b) in solvers.items()}
            kind = kind + PHYS
        starts = {"rest": {side: solvers[side][0].init_carry(
            double_dam_break(3_000).initial_state(device=dev), solvers[side][1])
            for side, dev in sides.items()}}
        if kind.startswith("dfsph"):
            solver, boundary = solvers["gpu"]
            carry, _ = run_steps(solver, starts["rest"]["gpu"], boundary, CONTACT_STEPS_3K)
            starts["contact"] = {"gpu": carry, "cpu": to_device(carry, sides["cpu"])}
        for start, carries in starts.items():
            runs = {}
            for side, carry in carries.items():
                solver, boundary = solvers[side]
                carry, counts = run_steps(solver, carry, boundary, 5)
                runs[side] = (counts, live_rows(solver.export_state(carry)), carry)
            (gc, grows, carry), (cc, crows, _) = runs["gpu"], runs["cpu"]
            crows = matched_rows(grows, crows)
            diff = None if crows is None else (grows - crows).abs().amax(0).tolist()
            log(f"phase 4 small reference: {kind} from {start}, {grows.shape[0]} particles, "
                f"(iterations, drops) gpu {gc} cpu {cc}, max |dx|, |dy|, |d density| "
                f"{diff!r}")
            # from rest both runs are bit-equal in practice; from contact, a
            # few ulps (K5 and its twin sum in other orders, the CPU's sqrt is
            # not correctly rounded) grow over the steps: the solver tolerances
            # of the CPU tests (positions atol 1e-5, densities rtol 1e-4 and
            # atol 1e-2)
            pos_rtol, rho_rtol, rho_atol = (1e-5, 1e-5, 1e-5) if start == "rest" \
                else (0.0, 1e-4, 1e-2)
            if gc != cc or crows is None or not (
                    torch.allclose(grows[:, :2], crows[:, :2], rtol=pos_rtol, atol=1e-5)
                    and torch.allclose(grows[:, 2], crows[:, 2], rtol=rho_rtol,
                                       atol=rho_atol)):
                raise RuntimeError(f"{kind}: GPU kernels and CPU twins disagree on the "
                                   f"small scene from {start}")
            if start == "contact":
                # a divergence loop of more than one iteration warm-starts the
                # next step's; the boundary pass found fluid -> wall pairs
                walls = wall_contact(carry)
                log(f"phase 4 small reference: {kind} from contact, wall contact "
                    f"(|sum grad W to the boundary|, a table's boundary neighbours) {walls!r}")
                if max(c[1] for c in gc[:-1]) <= 1 or walls == 0.0:
                    raise RuntimeError(f"{kind}: the contact state exercised no warm "
                                       "start or no fluid -> boundary pair")


def wall_contact(carry) -> float:
    """|sum of grad W to the boundary| of a DFSPH carry (the boundary
    neighbour count of a table carry): > 0 once fluid touches a wall."""
    if hasattr(carry, "neighborhood"):
        return float(carry.neighborhood.static.count.sum())
    return float(carry.ctx.sum_grad_stat.abs().sum())


def grid_text(grid) -> str:
    """A solver grid for the log: the slot grid's cells and occupancy, or
    the table solvers' cell size."""
    if hasattr(grid, "nx"):
        return f"grid {grid.nx}x{grid.ny} P {grid.occupancy}"
    return f"cell grid h {grid.cell_size!r}, K {grid.max_neighbors_dynamic}"


def carry_tensors(tree) -> list:
    """Every tensor of a carry (nested named tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for item in tree for t in carry_tensors(item)]
    return []


def _kernel_modules():
    from yasph2d_tpu_torch.ops import (
        pair_reduce, pallas_pair, rebucket, sm_pair_reduce, sm_rebucket,
    )
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor, vpu_probe

    return {"pair_reduce": pair_reduce, "sm_pair_reduce": sm_pair_reduce,
            "tile_pair_reduce": pallas_pair, "rebucket": rebucket,
            "sm_rebucket": sm_rebucket, "vpu_probe": vpu_probe,
            "probe_ctx": probe_pallas_slotmajor}


def reset_launch_counts():
    for mod in _kernel_modules().values():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    counts = {}
    for kernel, mod in _kernel_modules().items():
        for k, v in mod.LAUNCHES.items():
            counts[k if k.startswith(kernel) else f"{kernel}_{k}"] = v
    return counts


def phase_main_path(device, kind) -> tuple:
    """One of SOLVER_PATHS at 100k (module docstring); returns its launches
    and its run: per-step (iterations, drops), the live rows (x, y, vx, vy,
    density, on the CPU, in slot order) and h."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    world = double_dam_break(100_000)
    assert world.num_dynamic_particles == N_FLUID, world.num_dynamic_particles
    solver, boundary = bench_solver(kind, world, device)
    grid = solver.grid
    state = world.initial_state(device=device)
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    carry = solver.init_carry(state, boundary)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    diags = []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, d = solver.simulate(carry, boundary, 1)
        diags.append(d)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()

    s = solver.export_state(carry)
    live = int(s.alive.sum())
    rho0 = solver.properties.fluid_density
    pos, vel, dens = s.positions[s.alive], s.velocities[s.alive], s.densities[s.alive]
    finite = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()
                  and torch.isfinite(dens).all())
    dmin, dmax = float(dens.min()), float(dens.max())
    drops = max(d.neighbor_drops for d in diags)
    ms = elapsed / STEPS * 1e3
    log(f"phase 5 main path [{kind}]: {grid_text(grid)}, "
        f"{live} live / {world.num_boundary_particles} boundary, init {t_init:.3f} s, "
        f"{STEPS} steps {ms:.3f} ms/step {live * STEPS / elapsed:.1f} particle-steps/s, "
        f"drops {drops}, density [{dmin!r}, {dmax!r}], dt {float(carry.time.dt)!r}, "
        f"max |v| {float(max(d.max_velocity for d in diags))!r}")
    if kind.startswith("dfsph"):
        iters = [(d.density_iterations, d.divergence_iterations) for d in diags]
        log(f"phase 5 main path [{kind}]: iterations per step (density, divergence) "
            f"{iters}")
    log(f"phase 5 main path [{kind}]: drops per step {[d.neighbor_drops for d in diags]}")
    path = check_launches(kind, launches)
    off_card = [t.device for t in carry_tensors(carry) if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{kind}: carry tensors off the card: {off_card[:3]}")
    if drops != 0 or live != N_FLUID or not finite:
        raise RuntimeError(f"{kind}: main path state wrong: drops {drops} live {live} "
                           f"finite {finite}")
    if not (rho0 <= dmin and dmax <= 1.3 * rho0):
        raise RuntimeError(f"{kind}: densities outside [rho0, 1.3 rho0]: [{dmin}, {dmax}]")
    run = dict(counts=[(d.density_iterations, d.divergence_iterations, d.neighbor_drops)
                       for d in diags],
               rows=torch.cat([pos, vel, dens[:, None]], 1).cpu(),
               h=solver.properties.smoothing_length)
    return path, run


def compare_main_paths(runs: dict):
    """The unfused DFSPH plane path against the fused one: the same per-step
    iterations and drops (else it fails), and whether the live rows are
    bit-equal (logged); the K5 bf16 paths against the K5 f32 ones: sorted
    positions within BF16_POSITION_TOL h (else it fails)."""
    for kind, fused in FUSED_OF.items():
        a, b = runs[kind], runs[fused]
        same = a["rows"].shape == b["rows"].shape and torch.equal(
            a["rows"].view(torch.int32), b["rows"].view(torch.int32))
        log(f"phase 5 main path [{kind}]: per-step (iterations, drops) equal to {fused}'s "
            f"{a['counts'] == b['counts']}; live rows bit-equal {same}")
        if a["counts"] != b["counts"]:
            raise RuntimeError(f"{kind}: per-step iterations or drops differ from {fused}: "
                               f"{a['counts']} vs {b['counts']}")
    for kind, padded in LAYOUT_OF.items():
        a, b = runs[kind], runs[padded]
        diff = max(float(np.abs(np.sort(a["rows"][:, k].numpy())
                                - np.sort(b["rows"][:, k].numpy())).max()) for k in (0, 1))
        log(f"phase 5 main path [{kind}]: sorted x and y within {diff!r} m of {padded}'s; "
            f"per-step (iterations, drops) equal {a['counts'] == b['counts']}")
    for kind, f32 in F32_OF.items():
        a, b = runs[kind], runs[f32]
        diff = max(float(np.abs(np.sort(a["rows"][:, k].numpy())
                                - np.sort(b["rows"][:, k].numpy())).max()) for k in (0, 1))
        log(f"phase 5 main path [{kind}]: sorted x and y within {diff!r} m = "
            f"{diff / a['h']!r} h of {f32}'s (bound {BF16_POSITION_TOL} h); per-step "
            f"(iterations, drops) equal to {f32}'s {a['counts'] == b['counts']}")
        if a["rows"].shape != b["rows"].shape or diff > BF16_POSITION_TOL * a["h"]:
            raise RuntimeError(f"{kind}: sorted positions {diff / a['h']} h from {f32}'s")


def check_launches(kind, launches) -> dict:
    """The launches of `kind`'s kernels, each > 0; the table and sorted paths
    (NO_REBUCKET) also launch no re-bucket."""
    path = {k: launches[k] for k in PATHS[kind]}
    log(f"phase 5 main path [{kind}]: launches {path}")
    problems = [k for k, v in path.items() if v <= 0]
    if problems:
        raise RuntimeError(f"{kind}: kernels never launched on the main path: {problems}")
    if kind in NO_REBUCKET:
        rebuckets = {k: v for k, v in launches.items() if "rebucket" in k and v}
        if rebuckets:
            raise RuntimeError(f"{kind}: a table or sorted path launched re-buckets: "
                               f"{rebuckets}")
    return path


def baseline_config(kind, **solver):
    """BASELINE config 3, dfsph_high_viscosity (bench.py:353-361), as a
    config of `kind`: the reference dam-break (default_scene) at
    CONFIG_PARTICLES fluid particles, physical viscosity mu = 0.01, adaptive
    steps in [1/24000, 1/360] s with the kind's CFL (1.5 DFSPH, 0.2 WCSPH)."""
    from yasph2d_tpu_torch import config as C
    from yasph2d_tpu_torch.scenes import reference_particle_density

    return C.SimulationConfig(
        fluid=C.FluidConfig(particle_density=reference_particle_density(CONFIG_PARTICLES)),
        viscosity=C.ViscosityConfig(kind="physical", fluid_viscosity=0.01),
        timestep=C.TimestepConfig(timestep_max=1.0 / 360.0, timestep_min=1.0 / 24000.0),
        solver=C.SolverConfig(kind=kind, **solver))


def phase_config_path(device, rec: Records, name) -> dict:
    """One of CONFIG_PATHS through the CLI, in-process: its config written to
    a JSON file, `python -m yasph2d_tpu_torch run --config <file> --steps N`
    on the card; the run's drops 0, every fluid particle live, finite state,
    densities in [rho0, 1.3 rho0] at its end, and with rebuild_every k the
    re-bucket launched once per block of k steps plus once per leftover step;
    then `check_config_state` on its final state."""
    from pathlib import Path

    from yasph2d_tpu_torch.__main__ import main as cli

    kind, knobs, steps, _ = CONFIG_PATHS[name]
    path = Path(CONFIG_DIR) / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    baseline_config(kind, **knobs).to_json(str(path))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    run = cli(["run", "--config", str(path), "--steps", str(steps), "--device", str(device)])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    out, world, solver = run.record, run.world, run.solver
    s = solver.export_state(run.carry)
    live = int(s.alive.sum())
    rho0 = solver.properties.fluid_density
    dens = s.densities[s.alive]
    finite = bool(torch.isfinite(s.positions[s.alive]).all()
                  and torch.isfinite(s.velocities[s.alive]).all()
                  and torch.isfinite(dens).all())
    dmin, dmax = float(dens.min()), float(dens.max())
    grid = solver.grid
    log(f"phase 5 main path [{name}]: {kind} {knobs}, {grid_text(grid)}, "
        f"{live} live of {world.num_dynamic_particles} fluid / "
        f"{world.num_boundary_particles} boundary, {steps} steps in {elapsed:.3f} s "
        f"(build included), density [{dmin!r}, {dmax!r}], record {json.dumps(out)}")
    path_launches = check_launches(name, launches)
    k = int(getattr(solver, "rebuild_every", 1))
    rebuilds = steps // k + steps % k
    if k > 1 and launches["sm_rebucket"] != rebuilds:
        raise RuntimeError(f"{name}: {launches['sm_rebucket']} re-bucket launches in "
                           f"{steps} steps with rebuild_every {k}; expected {rebuilds}")
    if out["neighbor_drops"] != 0 or live != world.num_dynamic_particles or not finite \
            or not out["finite"]:
        raise RuntimeError(f"{name}: state wrong: drops {out['neighbor_drops']} live {live} "
                           f"of {world.num_dynamic_particles} finite {finite}")
    if not (rho0 <= dmin and dmax <= 1.3 * rho0):
        raise RuntimeError(f"{name}: densities outside [rho0, 1.3 rho0]: [{dmin}, {dmax}]")
    check_config_state(rec, name, run)
    return path_launches


def check_config_state(rec: Records, name, run):
    """The pair calls of a config path's step against their twins on the
    path's final state, at the shapes the path launches them at, with phase
    3's seeded noise (the fluid is falling freely: no shear, rho = rho0):
    the viscosity form (a *_phys form) RECORD, so its record's times, bound
    and launches all come from the config paths; the other forms CHECK."""
    kind, _, steps, kernels = CONFIG_PATHS[name]
    if not kernels:  # a table kind: no kernel to hold
        return
    where = f" on {name}"
    labels = check_state(rec, kind, run.solver, run.boundary, run.carry, where,
                         set(CONFIG_PATHS), RECORD)
    # the path that runs through contact ends with fluid on the ramp: its
    # boundary pass sums something
    contact = steps >= CONTACT_CONFIG
    rec.require_nonzero([label for label, sfx, mode in labels
                         if mode == RECORD or (contact and sfx == "[boundary]")])


def check_state(rec: Records, kind, solver, boundary, carry, where, paths, visc_mode):
    """The pair calls of a `kind` step (a config kind) against their twins
    on its `carry`, with phase 3's seeded noise: the viscosity form with
    `visc_mode`, the others CHECK. Returns each call's (nonzero label,
    label suffix, mode)."""
    rng = np.random.default_rng(5)
    if kind.endswith("plane"):
        kernel = "pair_reduce"
        variant = "_bf16" if solver.grid.pair_dtype == "bfloat16" else ""
        builder = dfsph_plane_calls if kind.startswith("dfsph") else partial(
            wcsph_plane_calls, rng=rng)
        geom, live, calls = builder(solver, boundary, carry, mode=CHECK, visc_mode=visc_mode)
        check_k1_calls(rec, geom, live, calls, variant, paths=paths, where=where)
    else:
        kernel = "sm_pair_reduce" if solver.grid.use_pallas_slotmajor else "tile_pair_reduce"
        variant = BF16 if solver.grid.pair_dtype == "bfloat16" else ""
        builder = dfsph_slot_calls if kind.startswith("dfsph") else wcsph_slot_calls
        if kind == "wcsph_dense":
            carry = padded_wcsph(solver, carry)
        (pos, mask), _, calls = builder(solver, boundary, carry, rng, mode=CHECK,
                                        visc_mode=visc_mode)
        check_slot_calls(rec, kernel, pos, mask, calls, paths, where)
    return [(f"{kernel}_{form.name}{sfx}{variant}{where}", sfx, mode)
            for sfx, form, _, _, _, mode in calls]


def phase_tool_path(device, kind) -> dict:
    """One of TOOL_PATHS through the tool's entry point, as a user runs it:
    the K6 rates (FMA, mix, HBM), the K7 probe beside K1 ctx, and the 1M bf16
    roofline, whose settled state must have no drop, every particle live and
    finite values (no density gate: the columns have hit the floor)."""
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor, roofline, vpu_probe

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    if kind == "vpu_probe":
        vpu_probe.main(["--device", str(device)])
    elif kind == "probe_ctx":
        probe_pallas_slotmajor.main(["gpu", "--device", str(device)])
    else:
        r = roofline.main([*ROOFLINE, "--pair-dtype", "bfloat16", "--device", str(device)])
        if r["drops"] != 0 or r["live"] != r["fluid"] or not r["finite"]:
            raise RuntimeError(f"roofline: settled state wrong: drops {r['drops']} live "
                               f"{r['live']} of {r['fluid']} finite {r['finite']}")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"phase 5 main path [{kind}]: {time.perf_counter() - t0:.2f} s")
    return check_launches(kind, launches)


# ---------------------------------------------------------------- sharded phase


def shard_setup(kind, device, particles):
    """(world, the one-device solver of `kind` (a solver kind, `_phys`: with
    physical viscosity) on the grid whose rows split over SHARD_RANKS shards,
    its full-grid BoundaryDense) of the double dam-break of ~`particles`."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    world = double_dam_break(particles)
    solver, _ = bench_solver(kind.removesuffix(PHYS), world, device, ny_multiple=SHARD_RANKS)
    if kind.endswith(PHYS):
        solver = physical(solver)
    return world, solver, world.boundary_dense(solver.grid, device=device)


def sharded_driver(kind):
    """The sharded driver class of a solver kind: plane or padded, DFSPH or
    WCSPH."""
    from yasph2d_tpu_torch.parallel import shard_dense, shard_plane

    dfsph = kind.startswith("dfsph")
    if "padded" in kind:
        return shard_dense.ShardedDFSPHPadded if dfsph else shard_dense.ShardedWCSPHPadded
    return shard_plane.ShardedDFSPHPlane if dfsph else shard_plane.ShardedWCSPHPlane


def kicked_state(world, device, kick):
    """The scene's initial state with every fluid particle moving `kick` m/s
    upward."""
    state = world.initial_state(device=device)
    return state._replace(velocities=state.velocities
                          + torch.tensor([0.0, kick], device=device))


def fluid_mask(carry):
    return carry.ctx.mask if hasattr(carry, "ctx") else carry.mask


def step_run(solver, boundary, carry, steps):
    """`steps` steps, each by `simulate(.., 1)` (so each step's diagnostics
    are read); (carry, per-step (density its, divergence its, drops),
    per-step (avg density error, avg divergence), live slots before and after
    each step, host ms/step)."""
    counts, avgs, live = [], [], [int(fluid_mask(carry).sum())]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
        avgs.append((float(d.avg_density_error), float(d.avg_divergence)))
        live.append(int(fluid_mask(carry).sum()))
    torch.cuda.synchronize()
    return carry, counts, avgs, live, (time.perf_counter() - t0) / steps * 1e3


def sharded_rank(group, kinds, scene):
    """One shard's share of a sharded run, for each of `kinds`: the driver
    (sharded_driver) on its rows of the kicked scene (`scene` = (particles,
    steps, kick)), init + its steps; returns per kind the per-step counts and
    averages, this shard's live slots per step, host ms/step, the launches
    of the run and the gathered live rows (x, y, vx, vy, density)."""
    particles, steps, kick = scene
    out = {}
    for kind in kinds:
        world, solver, boundary = shard_setup(kind, group.device, particles)
        # the DFSPH plane solver's fuse switches reach the shard solver
        switches = {f: getattr(solver, f) for f in ("fuse_loop_elementwise",
                                                    "fuse_ctx_elementwise") if hasattr(solver, f)}
        sharded = sharded_driver(kind)(group, viscosity_model=solver.viscosity_model,
                                       properties=solver.properties, full_grid=solver.grid,
                                       step_config=solver.step_config, **switches)
        state = kicked_state(world, group.device, kick)
        torch.cuda.synchronize()
        reset_launch_counts()
        carry, b = sharded.init(state, boundary)
        carry, counts, avgs, live, ms = step_run(sharded, b, carry, steps)
        launches = launch_counts()
        rows = sharded.gather_live_rows(carry).cpu()
        out[kind] = dict(counts=counts, avgs=avgs, live=live, ms=ms, launches=launches,
                         rows=rows, shard_rows=sharded.solver.grid.ny)
    return out


def one_device_reference(kind, device, scene):
    """The one-device solver on the sharded runs' grid and state."""
    particles, steps, kick = scene
    world, solver, boundary = shard_setup(kind, device, particles)
    if hasattr(solver, "boundary_planes"):  # the plane solvers
        boundary = solver.boundary_planes(boundary)
    carry = solver.init_carry(kicked_state(world, device, kick), boundary)
    carry, counts, avgs, live, ms = step_run(solver, boundary, carry, steps)
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive].cpu()
    return dict(solver=solver, boundary=boundary, carry=carry, counts=counts, avgs=avgs,
                ms=ms, rows=rows, grid=solver.grid)


def sorted_positions(rows):
    p = rows[:, :2].numpy()
    return p[np.lexsort(p.T)]


def compare_sharded(name, kind, ref, run, ranks) -> dict:
    """A sharded run against the one-device reference: equal per-step
    iterations and drops, every fluid particle live, a net seam crossing
    above 0 with two shards, and the live rows bit-equal; for the padded
    kinds, whose residual averages could move an exit by their last bits,
    the same iterations with live positions within 5e-5 (the JAX test's
    tolerance, tests/test_shard_padded.py) also pass, and the log says which
    held. Logs the largest relative difference of the residual averages
    (sums of per-shard sums)."""
    rel = max((abs(a - b) / max(abs(b), 1e-30) for sa, sb in zip(run[0]["avgs"], ref["avgs"])
               for a, b in zip(sa, sb)), default=0.0)
    crossed = [abs(b - a) for a, b in zip(run[0]["live"], run[0]["live"][1:])]
    same_counts = all(r["counts"] == ref["counts"] for r in run)
    equal_rows = all(r["rows"].shape == ref["rows"].shape
                     and torch.equal(r["rows"].view(torch.int32), ref["rows"].view(torch.int32))
                     for r in run)
    close = "padded" in kind and same_counts and all(
        r["rows"].shape == ref["rows"].shape
        and np.abs(sorted_positions(r["rows"]) - sorted_positions(ref["rows"])).max() <= 5e-5
        for r in run)
    held = "live rows bit-equal" if equal_rows else (
        "positions within 5e-5, rows not bit-equal" if close else "rows differ")
    log(f"phase 6 sharded [{name}]: {ranks} rank(s), {run[0]['shard_rows']} rows a shard, "
        f"{ref['rows'].shape[0]} live; host ms/step sharded "
        f"{[round(r['ms'], 3) for r in run]} one-device {ref['ms']:.3f}; iterations "
        f"equal {same_counts}, {held}; largest relative difference of the residual "
        f"averages {rel!r}; net particles across the seam per step (shard 0) {crossed}")
    if kind.startswith("dfsph"):
        log(f"phase 6 sharded [{name}]: (iterations, drops) per step {run[0]['counts']}")
    if not same_counts or not (equal_rows or close):
        raise RuntimeError(f"{name}: the sharded run differs from the one-device run")
    if ref["rows"].shape[0] != N_FLUID or any(c[2] for c in ref["counts"]):
        raise RuntimeError(f"{name}: particles dropped")
    if ranks > 1 and sum(crossed) == 0:
        raise RuntimeError(f"{name}: no particle crossed the seam")
    launches = {k: sum(r["launches"].get(k, 0) for r in run) for k in run[0]["launches"]}
    return check_launches(name, launches)


def nccl_one_rank(device, kinds, scene) -> dict:
    """The sharded driver on a one-rank NCCL group in this process (its halo
    rows are the mesh's dead edges)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from yasph2d_tpu_torch.parallel.comm import SpaceGroup

    workdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{workdir}/store", world_size=1,
                            rank=0)
    try:
        return sharded_rank(SpaceGroup.world(device, "nccl"), kinds, scene)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)


def band_rows(t, r0, r1, dim=-2):
    """Rows [r0, r1) of `t` along its row axis `dim` (-2 for (..., ny, nx)
    planes, 0 for (ny, nx, P, ...) slots)."""
    return t.narrow(dim, r0, r1 - r0).contiguous()


def halo_of(t, r0, r1, dim=-2):
    """Rows r0 - 1 and r1 of `t` along `dim`, stacked there (2 rows), zero off
    the grid: the rows a shard of rows [r0, r1) receives."""
    rows = [t.narrow(dim, r, 1) if 0 <= r < t.shape[dim]
            else torch.zeros_like(t.narrow(dim, 0, 1)) for r in (r0 - 1, r1)]
    return torch.cat(rows, dim=dim).contiguous()


def band_call(call, r0, r1, ny, mode):
    """A K1 call of the whole grid as the shard of rows [r0, r1) makes it: its
    source geometry's and values' rows -1 and ny from the neighbours."""
    from yasph2d_tpu_torch.ops.planes import Halo

    suffix, form, src, kw, c, _ = call
    halo = Halo((halo_of(src.pos, r0, r1), halo_of(src.mask, r0, r1)), r0, ny)
    src = src._replace(pos=band_rows(src.pos, r0, r1), mask=band_rows(src.mask, r0, r1),
                       halo=halo)
    kb = {k: tuple(band_rows(t, r0, r1) for t in kw[k])
          for k in ("q_vals", "s_vals", "post_planes") if k in kw}
    kb["scalars"] = kw.get("scalars", ())
    kb["s_halo"] = tuple(halo_of(t, r0, r1) for t in kw.get("s_vals", ()))
    return suffix, form, src, kb, c, mode


def halo_extras(q, src, kw):
    """(`check_pair`'s `halo`) of a K1 halo call: its geometry with the
    source's halo rows (the query between two dead rows), and the bytes it
    reads from them: the halo masks in full, positions and values of the
    live halo slots next to a live query of the band's edge rows (row -1
    feeds row 0 only, row ny row ny - 1)."""
    from yasph2d_tpu_torch.ops.planes import PlaneGeom

    h_pos, h_mask = src.halo.planes

    def ext(t, rows):
        return torch.cat([rows[..., :1, :], t, rows[..., 1:, :]], dim=-2)

    def dead(t):
        return torch.zeros_like(t[..., :2, :])

    pairs = k1_pairs(PlaneGeom(ext(q.pos, dead(q.pos)), ext(q.mask, dead(q.mask)),
                               q.rebase_cell),
                     PlaneGeom(ext(src.pos, h_pos), ext(src.mask, h_mask), src.rebase_cell))
    edge = torch.stack([q.mask[:, 0].any(0), q.mask[:, -1].any(0)]).to(torch.float32)
    near = torch.nn.functional.max_pool1d(edge[:, None], 3, stride=1, padding=1)[:, 0] > 0
    need = int((h_mask & near[None]).sum())
    per_slot = sum(nbytes(t) // h_mask.numel() for t in (h_pos, *kw["s_halo"]))
    return pairs, nbytes(h_mask) + per_slot * need


def check_halo_k1(rec: Records, kind, ref, paths):
    """K1's halo forms on the two shards' states (the one-device final state,
    bit-equal to the gathered sharded state, cut at the seam): each call of
    the step against its twin, bit-equal, RECORD on shard 0 (times, bound
    with the halo rows), CHECK on shard 1."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr

    solver, boundary, carry = ref["solver"], ref["boundary"], ref["carry"]
    if kind.endswith("_unfused"):  # the no-epilogue forms (ctx: the fused kinds')
        geom, live, calls = dfsph_plane_calls(solver, boundary, carry, unfused_mode=RECORD)
        calls = [c for c in calls if c[1].name in DFSPH_UNFUSED_FORMS[1:]]
    elif kind.startswith("dfsph"):
        geom, live, calls = dfsph_plane_calls(solver, boundary, carry)
    else:
        geom, live, calls = wcsph_plane_calls(solver, boundary, carry,
                                              np.random.default_rng(6))
    variant = ("_bf16" if kind.endswith("_bf16") else "") + HALO
    ny = solver.grid.ny
    for k, (r0, r1) in enumerate(((0, ny // SHARD_RANKS), (ny // SHARD_RANKS, ny))):
        q = geom._replace(pos=band_rows(geom.pos, r0, r1), mask=band_rows(geom.mask, r0, r1))
        where = f" on shard {k} of {kind}"
        for call in calls:
            suffix, form, src, kw, c, mode = band_call(call, r0, r1, ny, RECORD if k == 0
                                                       else CHECK)
            rec.check_pair(
                "pair_reduce", form.name + suffix, form,
                lambda: pr.pair_reduce(form, q, src, c, **kw),
                lambda: pr.pair_reduce_ref(form.term_fn, form.n_out, q, src, c.radius_sq,
                                           post_fn=form.post_fn, n_acc=form.n_acc, **kw),
                band_rows(live, r0, r1), 0, role_tensors(q.pos, src.pos, kw),
                [q.mask, src.mask], k1_pairs(q, src), c.radius_sq, variant, paths=paths,
                mode=mode, where=where, halo=halo_extras(q, src, kw))
    forms = [c[1].name for c in calls if not c[0]]  # the step's forms, once each
    rec.require_nonzero([f"pair_reduce_{f}{variant}" for f in dict.fromkeys(forms)])


def k2_operands(kind, carry):
    """(advected positions, mask, payload parts) of the re-bucket of `kind`'s
    plane step on `carry`: DFSPH (v, kappa, stiff), WCSPH the half-kicked v."""
    dt = carry.time.dt
    if kind.startswith("dfsph"):
        ctx = carry.ctx
        return ctx.pos + carry.v * float(dt), ctx.mask, (carry.v, carry.kappa, carry.stiff)
    v = carry.v + float(np.float32(0.5) * dt) * carry.accel
    return carry.pos + v * float(dt), carry.mask, (v,)


def check_halo_k2(rec: Records, kind, ref, name, paths):
    """K2's halo form with the payload of `kind`'s step on the two shards of
    its final state: the step's own advection (RECORD `name` on shard 0, the
    bound with the halo rows) and a forced overflow, each bit-equal to its
    twin, and the two shards' outputs the one-device re-bucket's rows."""
    from yasph2d_tpu_torch.ops import rebucket as rb
    from yasph2d_tpu_torch.ops.planes import Halo, pf_move_codes

    grid = ref["solver"].grid
    pos, mask, whole = k2_operands(kind, ref["carry"])
    extra = torch.cat([t if t.ndim == 4 else t[None] for t in whole], dim=0)
    odd = (torch.arange(grid.nx, device=pos.device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[0] -= odd * grid.cell_size
    ny, half = grid.ny, grid.ny // SHARD_RANKS
    band_grid = dataclasses.replace(grid, ny=half)
    for label, p in (("advect", pos), ("overflow", crowded)):
        full = rb.rebucket_ref(p, mask, extra, grid)
        drops = 0
        for k, (r0, r1) in enumerate(((0, half), (half, ny))):
            bp, bm = band_rows(p, r0, r1), band_rows(mask, r0, r1)
            parts = tuple(band_rows(t, r0, r1) for t in whole)
            bx = band_rows(extra, r0, r1)
            h_mask, h_pos = halo_of(mask, r0, r1), halo_of(p, r0, r1)
            halo = Halo((h_mask, h_pos, *(halo_of(t, r0, r1) for t in whole)), r0, ny)
            twin_halo = Halo((h_mask, h_pos, halo_of(extra, r0, r1)), r0, ny)
            # halo bytes: the mask rows, the live halo slots' positions (their
            # codes), the payload of those that move into this shard
            codes = [pf_move_codes(h_pos[..., i:i + 1, :], h_mask[:, i:i + 1], band_grid,
                                   r0 - 1 if i == 0 else r1, ny) for i in (0, 1)]
            arrive = int(((codes[0] >= 7) & h_mask[:, :1]).sum()
                         + ((codes[1] >= 1) & (codes[1] <= 3) & h_mask[:, 1:]).sum())
            n_live = int(h_mask.sum())
            halo_bytes = (nbytes(h_mask) + nbytes(h_pos) // h_mask.numel() * n_live
                          + nbytes(extra) // mask.numel() * arrive)
            run_kernel = partial(rb.rebucket_planes, bp, bm, parts, band_grid, halo=halo)
            run_twin = partial(rb.rebucket_ref, bp, bm, bx, band_grid, halo=twin_halo)
            if k == 0:  # the fluid's shard: the advection's record, the forced drops
                rec.check_rebucket("rebucket", f"halo {kind} {label} shard {k}", run_kernel,
                                   run_twin, overflow=label == "overflow",
                                   inputs=[bp, bm, bx], name=name, paths=paths,
                                   halo=(halo_bytes, n_live))
            out = run_kernel()
            stacked = torch.cat([v if v.ndim == 4 else v[None] for v in out[2]])
            if not bit_equal([out[0], out[1], stacked, out[3]], run_twin()):
                raise RuntimeError(f"rebucket_halo [{kind} {label} shard {k}] is not "
                                   "bit-equal to its twin")
            same = bit_equal([out[0], out[1], stacked],
                             [band_rows(t, r0, r1) for t in full[:3]])
            drops += int(out[3])
            if not same:
                raise RuntimeError(f"rebucket_halo [{kind} {label} shard {k}] differs from "
                                   "the one-device re-bucket's rows")
        log(f"phase 6 sharded: rebucket_halo [{kind} {label}] both shards = the one-device "
            f"rows, drops {drops} (one device {int(full[3])})")
        if drops != int(full[3]) or (label == "overflow") != (drops > 0):
            raise RuntimeError(f"rebucket_halo [{kind} {label}]: drops {drops}, one device "
                               f"{int(full[3])}")


slot_band = partial(band_rows, dim=0)
slot_halo = partial(halo_of, dim=0)


def slot_halo_extras(q_pos, q_mask, s_pos, s_mask, halo):
    """(`check_pair`'s `halo`) of a K5 halo call: its slots with the source's
    halo rows (the query between two dead rows), and the bytes it reads from
    them: the halo masks in full, positions and values of the live halo
    slots next to a live query of the band's edge rows (row -1 feeds row 0
    only, row ny row ny - 1)."""
    h_pos, h_mask, *h_vals = halo.planes

    def ext(t, rows):
        return torch.cat([rows[:1], t, rows[1:]])

    def dead(t):
        return torch.zeros_like(t[:2])

    pairs = (ext(q_pos, dead(q_pos)), ext(q_mask, dead(q_mask)), ext(s_pos, h_pos),
             ext(s_mask, h_mask))
    edge = torch.stack([q_mask[0].any(-1), q_mask[-1].any(-1)]).to(torch.float32)
    near = torch.nn.functional.max_pool1d(edge[:, None], 3, stride=1, padding=1)[:, 0] > 0
    need = int((h_mask & near[..., None]).sum())
    per_slot = sum(nbytes(t) // h_mask.numel() for t in (h_pos, *h_vals))
    return pairs, nbytes(h_mask) + per_slot * need


def check_halo_k5(rec: Records, kind, ref, paths):
    """K5's halo forms on the two shards' states of a padded kind (the
    one-device final state, equal to the gathered sharded state, cut at the
    seam): each call of the step (phase 3's, with its seeded noise) against
    its twin at K5's tolerance, RECORD on shard 0 (times, the bound with the
    halo rows), CHECK on shard 1."""
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops.planes import Halo

    solver, boundary, carry = ref["solver"], ref["boundary"], ref["carry"]
    rng = np.random.default_rng(6)
    slot_calls = dfsph_slot_calls if kind.startswith("dfsph") else wcsph_slot_calls
    (pos, mask), _, calls = slot_calls(solver, boundary, carry, rng)
    ny = solver.grid.ny
    bf16 = solver.grid.pair_dtype == "bfloat16"
    for k, (r0, r1) in enumerate(((0, ny // SHARD_RANKS), (ny // SHARD_RANKS, ny))):
        qp, qm = slot_band(pos, r0, r1), slot_band(mask, r0, r1)
        where = f" on shard {k} of {kind}"
        for suffix, form, (s_pos, s_mask), kw, c, _ in calls:
            halo = Halo(tuple(slot_halo(t, r0, r1)
                              for t in (s_pos, s_mask, *kw.get("s_vals", ()))), r0, ny)
            kb = {key: tuple(slot_band(t, r0, r1) for t in kw[key])
                  for key in ("q_vals", "s_vals") if key in kw}
            kb["scalars"] = kw.get("scalars", ())
            sp, sm = slot_band(s_pos, r0, r1), slot_band(s_mask, r0, r1)
            extras = slot_halo_extras(qp, qm, sp, sm, halo)
            if bf16:  # rebased on the band's global rows (the counted rows from r0 - 1)
                kb["rebase"] = kw["rebase"]._replace(row0=r0)
                extras = ((*extras[0], None, kw["rebase"]._replace(row0=r0 - 1)), extras[1])
            rec.check_pair(
                "tile_pair_reduce", form.name + suffix, form,
                lambda: tpp.pallas_pair_reduce(form, qp, qm, sp, sm, c, halo=halo, **kb),
                lambda: tpp.pallas_pair_reduce_ref(form.term_fn, form.n_out, qp, qm, sp, sm,
                                                   c.radius_sq, halo=halo, **kb),
                qm, -1, role_tensors(qp, sp, kb), [qm, sm],
                (qp, qm, sp, sm, None, kb.get("rebase")), c.radius_sq,
                (BF16 if bf16 else "") + HALO, paths=paths, mode=RECORD if k == 0 else CHECK,
                where=where, halo=extras)
    rec.require_nonzero(halo_path(kind)[:-1])  # the K5 halo forms of the kind's step


def k4_operands(kind, carry):
    """(advected positions, mask, payload parts) of the re-bucket of `kind`'s
    padded step on `carry`: DFSPH (v, kappa, stiff), WCSPH the half-kicked v."""
    dt = carry.time.dt
    if kind.startswith("dfsph"):
        ctx = carry.ctx
        return (ctx.pos_pad + carry.v_pad * float(dt), ctx.mask,
                (carry.v_pad, carry.kappa_pad, carry.stiff_pad))
    v = carry.v_pad + float(np.float32(0.5) * dt) * carry.accel_pad
    return carry.pos_pad + v * float(dt), carry.mask, (v,)


def check_halo_k4(rec: Records, kind, ref, name, paths):
    """K4's halo form with the payload of `kind`'s padded step on the two
    shards of its final state: the step's own advection (RECORD `name` on
    shard 0, the bound with the halo rows) and a forced overflow, each
    bit-equal to its twin, and the two shards' outputs the one-device
    re-bucket's rows, with its drops."""
    from yasph2d_tpu_torch.ops import sm_rebucket as smr
    from yasph2d_tpu_torch.ops.dense_grid import move_codes
    from yasph2d_tpu_torch.ops.planes import Halo

    grid = ref["solver"].grid
    pos, mask, whole = k4_operands(kind, ref["carry"])
    extra = torch.cat([t if t.ndim == 4 else t[..., None] for t in whole], dim=-1)
    odd = (torch.arange(grid.nx, device=pos.device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    ny, half = grid.ny, grid.ny // SHARD_RANKS
    band_grid = dataclasses.replace(grid, ny=half)
    for label, p in (("advect", pos), ("overflow", crowded)):
        full = smr.sm_rebucket_ref(p, mask, extra, grid)
        drops = 0
        for k, (r0, r1) in enumerate(((0, half), (half, ny))):
            bp, bm = slot_band(p, r0, r1), slot_band(mask, r0, r1)
            parts = tuple(slot_band(t, r0, r1) for t in whole)
            bx = slot_band(extra, r0, r1)
            h_mask, h_pos = slot_halo(mask, r0, r1), slot_halo(p, r0, r1)
            halo = Halo((h_mask, h_pos, *(slot_halo(t, r0, r1) for t in whole)), r0, ny)
            twin_halo = Halo((h_mask, h_pos, slot_halo(extra, r0, r1)), r0, ny)
            # halo bytes: the mask rows, the live halo slots' positions (their
            # codes), the payload of those that move into this shard
            codes = [move_codes(h_pos[i:i + 1], h_mask[i:i + 1], band_grid,
                                r0 - 1 if i == 0 else r1, ny) for i in (0, 1)]
            arrive = int(((codes[0] >= 7) & h_mask[:1]).sum()
                         + ((codes[1] >= 1) & (codes[1] <= 3) & h_mask[1:]).sum())
            n_live = int(h_mask.sum())
            halo_bytes = (nbytes(h_mask) + nbytes(h_pos) // h_mask.numel() * n_live
                          + nbytes(extra) // mask.numel() * arrive)
            run_kernel = partial(smr.sm_rebucket_parts, bp, bm, parts, band_grid, halo=halo)
            run_twin = partial(smr.sm_rebucket_ref, bp, bm, bx, band_grid, halo=twin_halo)
            if k == 0:  # the advection's record, the forced drops
                rec.check_rebucket("sm_rebucket", f"halo {kind} {label} shard {k}", run_kernel,
                                   run_twin, overflow=label == "overflow",
                                   inputs=[bp, bm, bx], name=name, paths=paths,
                                   halo=(halo_bytes, n_live))
            out = run_kernel()
            stacked = torch.cat([v if v.ndim == 4 else v[..., None] for v in out[2]], dim=-1)
            if not bit_equal([out[0], out[1], stacked, out[3]], run_twin()):
                raise RuntimeError(f"sm_rebucket_halo [{kind} {label} shard {k}] is not "
                                   "bit-equal to its twin")
            drops += int(out[3])
            if not bit_equal([out[0], out[1], stacked],
                             [slot_band(t, r0, r1) for t in full[:3]]):
                raise RuntimeError(f"sm_rebucket_halo [{kind} {label} shard {k}] differs "
                                   "from the one-device re-bucket's rows")
        log(f"phase 6 sharded: sm_rebucket_halo [{kind} {label}] both shards = the "
            f"one-device rows, drops {drops} (one device {int(full[3])})")
        if drops != int(full[3]) or (label == "overflow") != (drops > 0):
            raise RuntimeError(f"sm_rebucket_halo [{kind} {label}]: drops {drops}, one device "
                               f"{int(full[3])}")


def phase_sharded(device, rec: Records) -> dict:
    """The sharded solvers (yasph2d_tpu_torch/parallel/) on the kicked 100k
    double dam-break, SHARD_STEPS steps each, against the one-device solver
    on the same grid: one NCCL rank in this process (DFSPH plane f32; host
    ms/step beside the one-device solver's), two gloo ranks sharing the card
    (halo rows staged through the host; the plane kinds DFSPH f32 and bf16,
    WCSPH f32, and the padded K5 kinds DFSPH and WCSPH, each with XSPH and
    with physical viscosity), and two NCCL ranks on two cards (DFSPH plane
    and padded K5) where the machine has two. Then K1's and K2's halo forms,
    and K5's and K4's, against their twins on the two shards' states."""
    from yasph2d_tpu_torch.parallel import comm

    t0 = time.perf_counter()
    scene = (SHARD_PARTICLES, SHARD_STEPS, SHARD_KICK)
    kinds = SHARD_KINDS + PADDED_SHARD_KINDS
    refs = {kind: one_device_reference(kind, device, scene) for kind in kinds}
    path_launches = {}
    name = ONE_RANK
    run = nccl_one_rank(device, ["dfsph_plane"], scene)["dfsph_plane"]
    path_launches[name] = compare_sharded(name, "dfsph_plane", refs["dfsph_plane"], [run], 1)
    runs = comm.spawn(sharded_rank, SHARD_RANKS, "gloo", [device] * SHARD_RANKS, kinds, scene)
    for kind in kinds:
        name = f"sharded2_gloo_{kind}"
        path_launches[name] = compare_sharded(name, kind, refs[kind],
                                              [r[kind] for r in runs], SHARD_RANKS)
    if torch.cuda.device_count() >= SHARD_RANKS:
        devices = [torch.device("cuda", i) for i in range(SHARD_RANKS)]
        runs = comm.spawn(sharded_rank, SHARD_RANKS, "nccl", devices, NCCL_KINDS, scene)
        for kind in NCCL_KINDS:
            name = f"sharded2_nccl_{kind}"
            path_launches[name] = compare_sharded(name, kind, refs[kind],
                                                  [r[kind] for r in runs], SHARD_RANKS)
    else:
        log(f"phase 6 sharded [sharded2_nccl_*]: not run: {torch.cuda.device_count()} "
            f"card(s); NCCL takes one card a rank")
    # the halo forms' records count the paths with two shards; K2's and K4's
    # payloads are the solver's (one record each), not the operand mode's or
    # the viscosity's
    paths = set(path_launches) - {ONE_RANK}
    plane = {p for p in paths if "plane" in p}
    padded = paths - plane
    for kind in SHARD_KINDS:
        check_halo_k1(rec, kind, refs[kind], plane)
    check_halo_k2(rec, "dfsph_plane", refs["dfsph_plane"], "rebucket" + HALO,
                  {p for p in plane if "dfsph" in p})
    check_halo_k2(rec, "wcsph_plane", refs["wcsph_plane"], "rebucket" + HALO + "_wcsph",
                  {p for p in plane if "wcsph" in p})
    for kind in PADDED_SHARD_KINDS:
        check_halo_k5(rec, kind, refs[kind], padded)
    check_halo_k4(rec, "dfsph_padded_k5", refs["dfsph_padded_k5"], "sm_rebucket" + HALO,
                  {p for p in padded if "dfsph" in p})
    check_halo_k4(rec, "wcsph_padded_k5", refs["wcsph_padded_k5"],
                  "sm_rebucket" + HALO + "_wcsph", {p for p in padded if "wcsph" in p})
    log(f"phase 6 sharded: {time.perf_counter() - t0:.1f} s")
    return path_launches


# -------------------------------------------------------------------- app phase


def read_png(path) -> np.ndarray:
    """An 8-bit RGB PNG as the recorder writes it (one zlib stream over the
    IDAT chunks, filter 0 on every row), decoded with the standard library:
    the card's host need not have PIL."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path}: not a PNG")
    pos, idat, shape = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise RuntimeError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2):
                raise RuntimeError(f"{path}: not 8-bit RGB ({depth}, {color})")
            shape = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise RuntimeError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def fluid_pixels(image) -> int:
    """Pixels of neither the background's nor the boundary's colour."""
    from yasph2d_tpu_torch.render.renderer import BACKGROUND_COLOR, BOUNDARY_COLOR

    other = np.ones(image.shape[:2], dtype=bool)
    for color in (BACKGROUND_COLOR, BOUNDARY_COLOR):
        other &= (image != (np.asarray(color) * 255.0 + 0.5).astype(np.uint8)).any(-1)
    return int(other.sum())


@contextlib.contextmanager
def frame_times():
    """The host time of each app frame's parts while the block runs:
    `simulate` (SimulationApp.update), `render` (SimulationApp.draw less its
    submit: read-back and rasterise), `submit` (Recorder.save_frame, the PNG
    queue), `flush` (each Recorder.flush), and the solver `steps` of each
    frame (read as draw starts, before it resets them)."""
    from yasph2d_tpu_torch.app import SimulationApp
    from yasph2d_tpu_torch.render.renderer import Recorder

    t = {part: [] for part in ("simulate", "draw", "submit", "flush", "steps")}
    patched = ((SimulationApp, "update", "simulate"), (SimulationApp, "draw", "draw"),
               (Recorder, "save_frame", "submit"), (Recorder, "flush", "flush"))

    def timed(fn, part):
        def run(self, *args):
            if part == "draw":
                t["steps"].append(self.time_manager.num_simulation_steps_this_frame)
            t0 = time.perf_counter()
            out = fn(self, *args)
            t[part].append(time.perf_counter() - t0)
            return out
        return run

    originals = [getattr(cls, attr) for cls, attr, _ in patched]
    for (cls, attr, part), fn in zip(patched, originals):
        setattr(cls, attr, timed(fn, part))
    try:
        yield t
    finally:
        for (cls, attr, _), fn in zip(patched, originals):
            setattr(cls, attr, fn)
    t["render"] = [d - s for d, s in zip(t.pop("draw"), t["submit"])]


def timer_line(t) -> str:
    ms = {part: [round(1e3 * v, 2) for v in t[part]] for part in ("simulate", "render", "submit")}
    means = ", ".join(f"{part} {np.mean(v):.2f}" for part, v in ms.items())
    return (f"ms per frame (mean of {len(ms['simulate'])}): {means}; per frame "
            f"{ms['simulate']} simulate, {ms['render']} render, {ms['submit']} submit")


def phase_app(device, rec: Records, name):
    """One of APP_PATHS through `python -m yasph2d_tpu_torch record`,
    in-process: APP_FRAMES recorded frames at APP_RESOLUTION into a temporary
    directory, the kind's kernels launched, no drop, every fluid particle
    live, finite state, no app warning, `flush()` 0, the PNGs named as the
    Recorder names them, each decoded to the resolution with fluid pixels,
    the last one the native renderer's frame of the final state, and the
    native and NumPy renderers within 1% of pixels on that state. Then
    APP_REALTIME_FRAMES frames in realtime mode on the same app: whether the
    governor dropped steps is logged, not gated. Last, every pair form of the
    app's step and its re-bucket against their twins on the record's final
    state (`check_state`, `check_plane_rebucket`, `check_padded_rebucket`),
    at the app's shapes, check-only: the kernel records keep their times and
    launches from the paths of phases 3-6, and take the errors."""
    import tempfile
    from pathlib import Path

    from yasph2d_tpu_torch.__main__ import main as cli
    from yasph2d_tpu_torch.app import UpdateMode
    from yasph2d_tpu_torch.render.renderer import ParticleRenderer

    kind, kernels = APP_PATHS[name]
    cfg = Path(CONFIG_DIR) / f"{name}.json"
    cfg.parent.mkdir(parents=True, exist_ok=True)
    baseline_config(kind).to_json(str(cfg))
    w, h = APP_RESOLUTION
    with tempfile.TemporaryDirectory(prefix=f"{name}_") as out:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with frame_times() as times:
            app = cli(["record", "--config", str(cfg), "--frames", str(APP_FRAMES), "--out",
                       out, "--resolution", f"{w}x{h}", "--device", str(device)])
        elapsed = time.perf_counter() - t0
        launches = launch_counts()
        path = {k: launches[k] for k in kernels}
        tm, world = app.time_manager, app.world
        grid = app.solver.grid
        log(f"phase 7 app [{name}]: {kind}, {grid_text(grid)}, "
            f"{world.num_dynamic_particles} fluid / {world.num_boundary_particles} boundary, "
            f"{APP_FRAMES} frames {w}x{h} in {elapsed:.3f} s (solver build and init "
            f"included), {tm.num_simulation_steps} steps, simulated "
            f"{tm.total_simulated_time!r} s, dt {tm.simulation_step!r} | {gpu_line()}")
        log(f"phase 7 app [{name}]: steps per frame {times['steps']}")
        log(f"phase 7 app [{name}]: {timer_line(times)}; final flush "
            f"{1e3 * times['flush'][-1]:.2f} ms")
        log(f"phase 7 app [{name}]: launches {path}")
        errors = app.recorder.flush()
        s = app.solver.export_state(app.carry)
        live = int(s.alive.sum())
        finite = bool(torch.isfinite(s.positions[s.alive]).all()
                      and torch.isfinite(s.velocities[s.alive]).all()
                      and torch.isfinite(s.densities[s.alive]).all())
        drops = int(app.last_diagnostics.neighbor_drops)
        warnings = list(app.warnings)
        positions, velocities = app.particle_state()
        native = app.renderer.render(positions, velocities, app._boundary_render_positions)
        plain = ParticleRenderer(camera=app.camera, particle_radius=app.renderer.particle_radius,
                                 resolution=app.renderer.resolution, use_native=False)
        t1 = time.perf_counter()
        numpy_frame = plain.render(positions, velocities, app._boundary_render_positions)
        t_numpy = time.perf_counter() - t1
        mismatch = float((native != numpy_frame).any(-1).mean())
        dens = s.densities[s.alive]
        log(f"phase 7 app [{name}]: {live} live, drops {drops}, finite {finite}, density "
            f"[{float(dens.min())!r}, {float(dens.max())!r}], warnings "
            f"{warnings[:3]}, flush {errors}; native vs NumPy renderer on the "
            f"final state: {mismatch:.4%} of pixels differ (NumPy {1e3 * t_numpy:.1f} ms)")
        final = app.carry  # the step is functional: realtime steps leave it as it is

        app.set_update_mode(UpdateMode.REALTIME, reset=False)
        realtime = []
        realtime_frames = APP_REALTIME_FRAMES if kernels else APP_REALTIME_FRAMES_TABLE
        for _ in range(realtime_frames):
            app.update()
            steps = tm.num_simulation_steps_this_frame
            app.draw()
            realtime.append((steps, app.simulation_is_realtime,
                             round(1e3 * tm.duration_last_frame, 2)))
        dropped = sum(not r for _, r, _ in realtime)
        log(f"phase 7 app [{name}]: realtime {realtime_frames} frames (steps, realtime, "
            f"frame ms) {realtime}: the governor dropped steps in {dropped} of them; "
            f"simulated {tm.total_simulated_time!r} s, warnings {list(app.warnings)[:3]}")
        # after the realtime frames, which a long pause before them would
        # change (the governor treats it as lag)
        where = f" on {name}"
        if kernels:  # the table kind has no kernel to hold
            labels = check_state(rec, kind, app.solver, app.boundary, final, where, None,
                                 CHECK)
            # the fluid rests on the ramp by now: every form, the boundary pass
            # too, sums something
            rec.require_nonzero([label for label, _, _ in labels])
            (check_plane_rebucket if kind.endswith("plane") else check_padded_rebucket)(
                device, rec, app.solver, final, where=where)

        names = sorted(p.name for p in Path(out).iterdir())
        expected = sorted(f"{i}.png" for i in range(APP_FRAMES))
        t1 = time.perf_counter()
        images = [read_png(Path(out) / f"{i}.png") for i in range(APP_FRAMES)]
        counts = [fluid_pixels(im) for im in images]
        n_bytes = sum(os.path.getsize(Path(out) / n) for n in names)
        log(f"phase 7 app [{name}]: {len(names)} PNGs, {n_bytes} bytes, decoded in {time.perf_counter() - t1:.2f} s; fluid pixels per frame {counts}")
    problems = [k for k, v in path.items() if v <= 0]
    if problems:
        raise RuntimeError(f"{name}: kernels never launched on the app path: {problems}")
    if drops or live != world.num_dynamic_particles or not finite or warnings:
        raise RuntimeError(f"{name}: state wrong: drops {drops} live {live} of "
                           f"{world.num_dynamic_particles} finite {finite} warnings "
                           f"{warnings[:5]}")
    if errors != 0 or names != expected:
        raise RuntimeError(f"{name}: recorder: flush {errors}, files {names[:5]}...")
    if any(im.shape != (h, w, 3) for im in images) or min(counts) == 0:
        raise RuntimeError(f"{name}: frames wrong: shapes {[im.shape for im in images][:3]}, "
                           f"fluid pixels {counts}")
    if not np.array_equal(images[-1], native):
        raise RuntimeError(f"{name}: the last PNG is not the renderer's frame of the "
                           "final state")
    if mismatch >= 0.01:
        raise RuntimeError(f"{name}: native and NumPy renderers differ on {mismatch:.4%}")


def main():
    t0 = time.perf_counter()
    phase_environment()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    rec = Records()
    with phase_clock("3 kernels"):
        phase_kernels_dfsph(device, rec)
        phase_kernels_wcsph(device, rec)
        phase_kernels_dfsph_padded(device, rec)
        phase_kernels_dfsph(device, rec, "dfsph_plane_bf16")
        phase_kernels_wcsph_plane(device, rec, "wcsph_plane_bf16", np.random.default_rng(4))
        phase_kernels_probes(device, rec)
        phase_kernels_deep(device)
        phase_kernels_1m(device, rec)
    with phase_clock("4 small reference"):
        phase_small_reference(device)
    with phase_clock("5 main paths (solvers)"):
        runs = {kind: phase_main_path(device, kind) for kind in SOLVER_PATHS}
    path_launches = {kind: path for kind, (path, _) in runs.items()}
    compare_main_paths({kind: run for kind, (_, run) in runs.items()})
    with phase_clock("5 main paths (tools)"):
        path_launches.update({kind: phase_tool_path(device, kind) for kind in TOOL_PATHS})
    with phase_clock("5 main paths (configs)"):
        path_launches.update({name: phase_config_path(device, rec, name)
                              for name in CONFIG_PATHS})
    with phase_clock("6 sharded"):
        path_launches.update(phase_sharded(device, rec))
    # the app's launches are logged on its own lines: the kernel records
    # count the paths above
    for name in APP_PATHS:
        with phase_clock(f"7 app [{name}]"):
            phase_app(device, rec, name)
    records = list(rec.by_name.values())
    for r in records:
        # a record that names no path is one of the 100k solver states: it
        # counts the solver paths (the probes name their tools)
        counter, paths = r.pop("_counter"), r.pop("_paths") or SOLVER_PATHS
        r["launches"] = sum(counts.get(counter, 0) for kind, counts in path_launches.items()
                            if kind in paths)
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        raise RuntimeError(f"kernels of the JSON record never launched on a main path: "
                           f"{missing}")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
