#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (glomargridding_tpu_torch).

Drives the port's paths on one NVIDIA GPU and builds every kernel
they run from the sources in this checkout (``pairwise_tile.cu`` and
``ellipse_tile.cu``, compiled in parallel):

- phases 1-7, the stationary path: ordinary kriging of the 1-degree
  global grid (64,800 cells) from 5,000 observations, Matern nu = 0.5
  (sklearn convention), psill 1.2, range 1200 km, haversine distance and
  a diagonal error covariance, through ``kriging_from_kernel``; its tile
  kernel (K1) against its plain twin, the outputs against the same call
  in float64 on the card, the 100-member ensemble, the 259,200-cell grid
  and their times;
- phases 8-12, the non-stationary path: the ellipse kernels K2, K3 and K4
  against their plain twins; ``EllipseCovarianceBuilder`` on all 64,800
  cells (nu = 1.5, f32, 16.8 GB) with ``OrdinaryKriging``,
  ``SimpleKriging`` and ``crossval_from_covariance`` against an f64
  oracle; the bf16 operator at 64,800; the banded stream operator at
  259,200 cells (3,000 km cutoff); and their times. The ellipse fields
  are the JAX benchmark's ``realistic_ellipse_params`` (seed 42);
- phases 13-15, the repaired non-stationary pipeline at 64,800 cells,
  5,000 observations and 100 members (nu = 1.5, f32): the bf16 operator
  (K2) through ``explained_variance_clip_lowrank`` (target 0.90), with
  the partial clip held against the full spectrum on a sub-problem;
  ``pad_rank(256)`` and ``lowrank_kriging``, ``lowrank_ensemble_step``
  and ``lowrank_crossval`` against f64, against the dense-E route and
  against the dense classes on ``to_dense()``; and the dense stochastic
  path (``batched_ensemble_step``, ``StochasticKriging``) against
  ``lowrank_members_from_states`` on the same draws, with the
  eigen-repair rescue on an indefinite matrix. Each prints its own times;
- phases 16-18, the estimation path at 64,800 cells (nu = 1.5, f32): 60
  states drawn from phase 13's repaired covariance are the training
  cube of ``EllipseBuilder`` (dense correlation, 16.8 GB), and
  ``compute_params`` fits every cell's ellipse by Levenberg-Marquardt
  with the configuration of ``examples/nonstationary_1deg_pipeline.py``
  (the whole-grid simplex is phase 29's). The fit is held on 4,096 lanes
  against the f64 run of the same code, against the Levenberg-Marquardt
  lane, and against two controls that must do worse (the likelihood
  summed in f32, a fit at the wrong order), and one chunk of polar lanes
  is fitted in f64 by both optimisers; the fitted fields go through
  ``convert.ellipse_builder_from_dataset`` into K2, and the Hessian
  standard errors are read in f32 against f64;
- phase 19 measures what the thresholds of ``ops/covariance_tools`` and
  the locked widening of ``ops/eigsh`` stand on: the full against the
  partial clip at 2,048-16,384, ``to_dense()`` at 64,800, and a clip
  that has to widen, locking its converged pairs and locking none, on
  the bf16 store at 16,200 and 64,800 cells and on the 259,200-cell
  stream;
- phases 20-24, sampling and fitting: K_nu of general order, the sphere
  and Chebyshev samplers, the variogram MLE, and
  ``examples/nonstationary_1deg_pipeline.py`` with nothing cut;
- phases 25-27, the host-side modules on their paths: the HadSST4 /
  HadCRUT5 workflow at 5 degrees (``examples/torch_hadsst_workflow.py``:
  the ESA-CCI ellipse fit, K2, the f64 clip, the error covariance, the
  observations mapped to the grid, leave-one-out scores, kriging and a
  perturbed member, for March 2014 and March 1876) against f64 and the
  stored TPU run; the 41-March ESA-CCI scan
  (``examples/torch_esa_months_scan.py``, K1); and 2,000,000 raw
  observations binned on the card, a 10,000-record error covariance
  reduced to its 5,000 gridboxes and 64,800-cell kriging (K1);
- phase 28, the sharded paths of ``glomargridding_tpu_torch.parallel`` on
  a mesh of four slots of the card (4 x 1, and 2 x 2 for the factored
  path): the kriging of phase 4 with its grid columns sharded (K1), the
  64,800-cell covariance in row blocks (K4) against K2's matrix, the
  ring-SUMMA stream at 259,200 cells (K3, K4) and its clip at 64,800,
  the ensemble step's blocked Cholesky at 64,800 (f32 and f64), the
  factored kriging and ensemble, the blocked Cholesky and its solves at
  16,384 in f64, and the whole-grid fit's lanes split over the slots,
  each against its single-device call and with its time beside it;
- phase 29, ``examples/torch_nonstationary_quarter_degree.py`` at
  259,200 cells with nothing cut, through its stage functions: the
  training cube (f32 against f64), the lazy correlation, the whole-grid
  ellipse fit (its chunk sizes timed, two chunks refitted, its
  checkpoint resumed), the banded stream on the fitted fields (K3, K4)
  against an f64 slab of the plain twin, the clip, and kriging with 100
  members off the factors; phase 30, the three 1-degree twins
  (``examples/torch_nonstationary_65k_lowrank.py``: K2's bf16 store and
  its clip; ``examples/torch_large_ensemble_65k.py``: K1's tiles and the
  members; ``examples/torch_ellipse_1deg_covariance.py``: K4 at 40,000
  points);
- phase 32, K5 (the ellipse fit's Fisher-z objective,
  ``ops/cuda/ellipse_nll``) at the 1-degree fit's stacked call (4 points
  x 2,048 lanes x 4,096 columns, f32) against its plain twin, timed
  beside its bound with every lane live and with 3% of them, and the
  twin's time. Every Nelder-Mead fit of phases 16, 24, 25, 28 and 29
  that goes through ``EllipseBuilder._chunk_fitter`` runs on it: each of
  those phases prints its own K5 launches, and the kernel list sums
  them (phase 32's own launches left out).

Usage, from the repository root, with no arguments:

    python3 chip_smoke.py

One line per phase. Any failure raises and the script exits non-zero
without the final line. The final line is one JSON object with the
device; the line before it lists each kernel with its launch count on
its path, its error against the plain twin, its time, its plain twin's
time and its bound: the least time the card could take for the same
work, from this run's inputs (bytes over HBM's rate, or operations over
their peak rate, whichever is larger; see ``bound``). Phase 2 prints the
registers and spills nvcc reports for each kernel and fails if any
kernel spills.
"""

import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager
from itertools import product

import numpy as np
import torch

from glomargridding_tpu_torch.utils.profiling import COUNTS, spans_on
from glomargridding_tpu_torch.utils.roofline import (
    F32_FLOPS_S,
    K1_FLOPS,
    K1_POINT_TRANSCENDENTALS,
    K1_TRANSCENDENTALS,
    K3_CONTRACT_FLOPS,
    bound,
    ellipse_bound,
)

N_OBS = 5000
N_MEMBERS = 100
PSILL = 1.2
RANGE_KM = 1200.0
SEED = 0
REPEATS = 5

# K1 against its plain twin: max |kernel - plain| / variance. Both
# evaluate the same formula; the kernel's FMA contraction moves a few
# roundings. f64: a few ulp. f32: asin_poly's f32 value carries an
# absolute error of ~1 ulp of pi/2 (1.2e-7 rad) at every distance (it is
# a difference of two numbers near pi/2), so a few ulp there move d by
# up to ~5e-3 km and corr by scale * 5e-3 / range, up to ~1e-5.
TILE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# f32 kriging against the f64 run of the same call on the card, relative
# to each output's scale (max |field|, sqrt(variance), 1): f32 eps
# (6e-8) times cond(K) ~1e3 for K = C_obs + E with E >= 0.1.
KRIGING_TOL = 1e-3
# the ensemble's field is the ordinary field through a wider GEMM that
# sums in another order: both are f32 values of one quantity, each within
# KRIGING_TOL of f64, so they are held to each other by the same bound
ENSEMBLE_FIELD_TOL = KRIGING_TOL
# small f64 problem, card (kernel) vs CPU (plain twin)
SMALL_RTOL = 1e-10

# --- the non-stationary path
NU_NS = 1.5
MAX_DIST_KM = 3000.0
N_SYM = 16384  # bench.py:511-524's K2 size (seed 1 inputs)
N_RAGGED = 16421  # not a multiple of the 64-point tile
BAND_ROWS = slice(30000, 32048)  # a 2,048 x 64,800 row band of the 1 deg grid
STREAM_GRID = (360, 720)  # bench.py:835-839, 259,200 cells
WIDE_COLS = 1024
# K2/K4 against their plain twins, max |kernel - plain| / max |plain|:
# the same formula in the same order; the kernel's exp/rsqrt/sin/cos are
# not torch's (a few ulp) and nvcc contracts some products into FMAs.
ELLIPSE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# K3 against its twin (relative to max |y|): f32 tiles summed with
# atomics in no fixed order; against the dense f64 product: the JAX
# test's bound (test_ellipse.py:1578-1582)
K3_TWIN_TOL = 1e-5
K3_DENSE_TOL = 1e-4
# the f32 builder's matrix against K4 in f64, relative to max |C|, off
# the pairs 180 degrees apart in longitude: the f32 pair function's own
# rounding (measured ~1.5e-6 on the H100)
COVARIANCE_TOL = 1e-4
# f32 dense kriging against f64 solves on the same matrix, by order. At
# nu = 0.5 the system is positive definite (cond ~1e3): KRIGING_TOL. At
# nu = 1.5 it is indefinite (lambda_min -0.54, cond 1.3e5 on the 1 degree
# fields, H100): f32 LU reads up to 4.0e-3 (the constraint mask), so the
# bound is a fixed 1e-2 until the PSD repair lands. Each order's bound
# must also reject the negative controls (DENSE_FAULTS).
DENSE_KRIGING_TOL = {0.5: KRIGING_TOL, 1.5: 1e-2}
# faults a dense kriging check must catch, read in f64 against the f64
# oracle: simple kriging where ordinary was asked for, and the
# observations' error variances 10% too large
DENSE_FAULTS = ("simple_for_ordinary", "error_cov_x1.1")
# the bf16 store's matvec against the dense f32 product, relative to
# max |y| (test_ellipse.py:713-716): bf16 keeps 8 bits of mantissa
BF16_TOL = 2e-2
# two f32 applications of one stream operator that differ only in the
# order they sum (K3's atomics against the GEMM; a GEMM over the band
# window against one over all columns), relative to max |y|
STREAM_ORDER_TOL = 1e-5

# --- the repaired pipeline (phases 13-15): bench.py:662-667's clip
CLIP_TARGET = 0.90
CLIP_KW = dict(k0=1024, max_rank=4096, n_iter=4, rank_multiple=128)
PAD_RANK = 256
# the factored covariance's trace against the operator's (the clip
# preserves it by construction: re-normalised columns, f64 gains)
TRACE_TOL = 1e-5
# the sub-problem on which the partial clip meets the full spectrum: the
# largest of these sizes whose f64 eigh is predicted (n^3, from a timed
# 4,096) to stay under the budget
SUB_SIZES = (16384, 12288, 8192, 4096)
SUB_EIGH_BUDGET_S = 15.0
# retained Ritz values against the full f64 spectrum, over theta_1, and
# the partial clip against the full clip, resynthesised, over max |C|;
# the partial clip at CLIP_WRONG_TARGET against the full clip at
# CLIP_TARGET must exceed the second bound, or it sees nothing
SUB_TOL = 1e-3
CLIP_WRONG_TARGET = 0.80
# RMSE against a truth drawn from the model, mean uncertainty and member
# spread (bench.py:698-724): largest over smallest
CONSISTENCY_RATIO = 1.05
# dense members against the factored ones on the same draws, over
# max |member|
MEMBERS_TOL = 1e-3

# --- the estimation path (phases 16-18): the fit of
# examples/nonstationary_1deg_pipeline.py:133-166 on every cell
T_TRAIN = 60
FIT_MODEL = dict(anisotropic=True, rotated=True, physical_distance=True,
                 v=NU_NS, unit_sigma=True)
FIT_KW = dict(
    max_distance=6000.0, guesses=[2000.0, 2000.0, 0.0],
    bounds=[(300.0, 30000.0), (300.0, 30000.0),
            (-2.0 * np.pi, 2.0 * np.pi)],
    tol=1e-3, chunk_size=2048, max_train_cols=4096)
FIT_DEFAULTS = [-999.9, -999.9, -999.9, -999.9, -1, -1]
# the lanes on which the fit is held: two of its chunks, around 10 S and
# 64 N
SUBSET_STARTS = (28672, 55296)
# a chunk of polar lanes, 81 to 87 N, looked at apart (`polar_lanes`)
POLAR_START = 61440
LM_TOL = 1e-8
# iterations of one chunk's solve that are timed and profiled for the
# device's idle share
PROFILE_ITERS = 64
# The fit in f32 against the f64 run of the same code, per lane with QC 0
# in both. Nelder-Mead stops when the simplex's spread in f and in x is
# under tol = 1e-3, so in a quadratic bowl f - f* = (dx/SE)^2 / 2 <= tol
# leaves a run within sqrt(2 tol) = 0.045 standard errors of its
# optimum, and two runs within 0.09 of each other. The Fisher-information
# SE of this cube (phase 18) is 0.096 L for the lengths and 0.16 rad for
# the angle at the median lane: 0.09 SE is 0.9% of a length and 0.014
# rad. That holds per lane only where the simplex still sees its
# objective at that size, which f32 does not grant everywhere: the model
# correlation's rounding leaves a few 1e-6 of noise in the f32 objective,
# above what the first steps in the angle (0.00025 rad, ~1e-6 in f)
# change, so on some lanes the simplex closes with the angle where it
# started and the lengths off with it (measured on an NVIDIA H100 80GB
# HBM3: 71% of lanes within the lengths' bound, 55% within all three;
# with the likelihood summed in f32, as in the reference, the median lane
# is 2% off and no angle moves: the run reads that control too, and it
# must do worse). Levenberg-Marquardt reads the angle's
# slope from its Jacobian, in f32 too, and meets the f64 simplex on 97%:
# the rest are lanes with two optima. So each comparison is held as the
# share of lanes within the bounds, and the control must fall under
# FIT_WRONG_SHARE.
FIT_REL_TOL = 0.01
FIT_THETA_TOL = 0.02
FIT_SHARE_NM_F32 = 0.6
# all three within their bounds: 54.7% measured; summed in f32 the angle
# stays where it started, and that control must fall under the bound
FIT_SHARE_NM_F32_ELLIPSE = 0.45
FIT_SHARE_LM = 0.9
FIT_WRONG_SHARE = 0.1
FIT_QC_SHARE = 0.98
# Hessian standard errors, f32 against f64 at the same point: the f32
# double-backward of a sum of 4,096 terms (measured 3.9e-4 at worst);
# finite wherever the curvature is positive, which the f64 optima are
# and the f32 simplex's stalled lanes need not be
SE_RTOL = 2e-3
SE_FINITE_SHARE = 0.99
SE_FINITE_SHARE_F32 = 0.8

# --- the thresholds (phase 19)
THRESHOLD_SIZES = (2048, 4096, 8192, 16384)
# the clips that compare the widening flavours start narrow so that they
# have to widen: the flavours differ only from the second stage on
WIDENING_SMALL_GRID = (90, 180)  # the 2-degree grid, 16,200 cells
WIDENING_CLIP_KW = dict(k0=512, max_rank=4096, n_iter=4, rank_multiple=128)

# Phases 20-24, sampling and fitting. K_nu against scipy on the card at
# the orders the port reaches only through the general-order K_nu: f64 to
# 1e-10 relative, f32 to the reference's 5e-5 (tests/test_special.py),
# off the underflow tail (and within the dtype's range).
KV_ORDERS = (0.3, 1.0, 1.25, 2.7)
KV_RTOL = {torch.float64: 1e-10, torch.float32: 5e-5}
KV_TAIL = {torch.float64: 1e-300, torch.float32: 1e-30}
NU_GENERAL = 1.0
GENERAL_REPEATS = 2  # each general-order kriging call is seconds
# examples/large_ensemble_65k.py:86-92: Matern 0.5, 1200 km, variance
# 1.2, nugget 0.012 on the 1-degree axes, the default l_max (540)
SPHERE_DEG, SPHERE_NUGGET = 1.0, 0.012
# the f32 device table against the host f64 table at l_max 540 (the
# reference holds 2e-3 at 256; the error grows with l: 4.1e-3 at 540 in
# the CPU's f32), and f32 draws against f64 on the same normals, of
# max |f| (3.3e-5 on the CPU)
SPHERE_TABLE_TOL = 1e-2
SPHERE_F32_TOL = 1e-3
# the statistics: STAT_DRAWS in batches of STAT_BATCH; the empirical
# covariance of STAT_REFS cells with every cell, binned by great-circle
# distance (the zero lag apart), held to STAT_SIGMAS standard errors of
# the batch means plus the variance the truncation drops
STAT_DRAWS, STAT_BATCH, STAT_REFS = 4000, 100, 64
STAT_BIN_KM, STAT_MAX_KM, STAT_SIGMAS = 200.0, 6000.0, 5.0
STAT_WRONG_RANGE = 1.25
# the Chebyshev sampler on the 2-degree grid (at 1 degree each matvec is
# a full 64,800^2 K1 pass plus its GEMM, ~30 ms, times ~1,000 degrees)
CHEB_GRID = (90, 180)
CHEB_F32_TOL = 1e-3
# the variogram MLE at the main path's 5,000 positions: the truth is
# Matern 1.5 (1,200 km, variance 1.2) observed with noise variance 0.1.
# L-BFGS against Nelder-Mead in f64 (both stop within ~1e-6 of the
# optimum in log-space), and f32 against f64 per optimiser: L-BFGS by
# its parameters (1.3e-5 on an H100); the f32 simplex by the f64
# likelihood where it stops, within a nat of the f64 optimum's (0.69 on
# an H100). Its parameters are not comparable: along the likelihood's
# ridge (psill / range^3 nearly constant at nu = 1.5) its vertices
# differ by less than the f32 objective's error (`f32_nll_error`, 6e-4
# at the f64 optimum on an H100), so the simplex crawls and spends its
# 600 iterations ~10% short
MLE_NOISE = 0.1
MLE_F32_RTOL = 1e-3
MLE_F32_NLL_GAP = 1.0
MLE_OPT_RTOL = 1e-3
# the general-order fit differentiates through the 110 fixed steps of
# K_nu: ~11 KB of saved tensors per pair in f64 (measured on the CPU),
# 280 GB at 5,000 observations, so it runs on the first 1,000 (8.5 GB)
MLE_GENERAL_N = 1000
# examples/torch_nonstationary_1deg_pipeline.py (the twin of
# examples/nonstationary_1deg_pipeline.py:86-239), as written
PIPE_OCEAN = 44420
PIPE_QC0_SHARE = 0.8

# --- the host-side paths (phases 25-27)
# The card's machine has no h5py (``import h5py`` raises
# ModuleNotFoundError there), so phases 25 and 26 read the workflow inputs
# from the bundle that the port's ``io.load_array`` wrote from the netCDF
# files (``examples/torch_workflow_data.py``), and phase 27's netCDF and
# LowRankPSD round trips run only in the CPU tests
# (``tests/test_torch_io.py``).
WORKFLOW_TOL = KRIGING_TOL  # f32 against f64 on the card
STORED_RUN = "examples/outputs/hadsst_workflow_fields.npz"
STORED_TOL = 1e-3  # the stationary fields of the stored TPU run (f32)
# the 5-degree ESA fit, f32 against f64 on the lanes both fit with QC 0:
# the share of lanes within FIT_REL_TOL, Lx and Ly each (95.5-95.6% of
# 1,483 lanes measured on an NVIDIA H100 80GB HBM3); the f32 fit at the
# wrong order (nu = 0.5) is the control that must fall under it
WORKFLOW_FIT_SHARE = 0.9
SPARSE_ERA = (1876, 94)  # (year, HadSST4 member)
# phase 27: raw observations over the main path's 5,000 cells of the
# 1-degree grid
RAW_OBS = 2_000_000
RAW_MAX_PER_BOX = 800
RAW_JITTER_DEG = 0.45
RAW_NOISE = 0.3
RAW_MEAN_RTOL = 1e-12
RECORDS_PER_BOX = 2
RECORD_SIGMA = {"ship": 0.6, "drifting_buoy": 0.25, "moored_buoy": 0.3,
                "argo": 0.1}
N_PLATFORMS = 400
PLATFORM_BIAS_RANGE = (0.05, 0.3)
GRIDBOX_ERROR_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}

# --- phase 28: the sharded paths (parallel/) on four slots of the card
SHARD_SLOTS = 4
# a sharded f32 call against the same call on one device: the same f32
# operations on the same values, with products over row or column blocks
# of other widths (cuBLAS picks its kernels, and so its summation order,
# by shape): a few ulp of each output's scale, amplified at most by the
# uncertainty's square root where the variance nearly cancels
SHARD_TOL = 1e-5
# the row blocks against K2's matrix, over max |C|: K4 and K2 evaluate
# the pair function identically (EllipseCovarianceBuilder's K2 and K4
# routes agree bit for bit, test_builder_routes_agree_bitwise), so exact
# up to the order of the diagonal's addition
SHARD_COV_TOL = 1e-6
# f64 sharded against f64 single-device: f64 eps (1.1e-16) times the
# growth through a Cholesky of cond ~357 (phase 14's K) and 32 blocks
SHARD_F64_TOL = 1e-9
# the blocked Cholesky and what applies it, f64 at SHARD_LINALG_N against
# torch.linalg: eps times sqrt(cond) of the sub-block
SHARD_LINALG_TOL = 1e-10
SHARD_LINALG_N = 16384
# the sharded fit against the unsharded fit of the same lanes, f64: each
# lane's optimiser sees the same values; its batch is a quarter as wide
SHARD_FIT_F64_RTOL = 1e-8


def sync():
    torch.cuda.synchronize()


def phase(number, title, **values):
    parts = [f"{k}={v}" for k, v in values.items()]
    print(f"phase {number} {title}: " + " ".join(parts), flush=True)


def max_rel(a, b, scale=None):
    """max |a - b| / scale (scale defaults to max |b|), as a float."""
    err = torch.max(torch.abs(a.double() - b.double())).item()
    ref = torch.max(torch.abs(b.double())).item() if scale is None else scale
    return err / ref


def grid_1deg():
    lat = np.arange(-89.5, 90.0, 1.0, dtype=np.float32)
    lon = np.arange(-179.5, 180.0, 1.0, dtype=np.float32)
    return np.repeat(lat, lon.size), np.tile(lon, lat.size)


def grid_linspace(n_lat, n_lon):
    half_dlat, half_dlon = 90.0 / n_lat, 180.0 / n_lon
    lat = np.linspace(-90 + half_dlat, 90 - half_dlat, n_lat).astype(np.float32)
    lon = np.linspace(-180 + half_dlon, 180 - half_dlon, n_lon).astype(
        np.float32
    )
    return np.repeat(lat, n_lon), np.tile(lon, n_lat)


def observations(m, device):
    """The benchmark's observation draw (seed 0), as f32 tensors."""
    rng = np.random.default_rng(SEED)
    idx = np.sort(rng.choice(m, size=N_OBS, replace=False)).astype(np.int64)
    y = rng.normal(size=N_OBS).astype(np.float32)
    err = np.diag((0.1 + 0.05 * rng.random(N_OBS)).astype(np.float32))
    return (
        torch.as_tensor(idx, device=device),
        torch.as_tensor(y, device=device),
        torch.as_tensor(err, device=device),
    )


def cuda_time_ms(fn, iters=20):
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / iters


def wall_median_s(fn):
    fn()
    sync()
    walls = []
    for _ in range(REPEATS):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def check_kriging(res, oracle, variance, label):
    errs = {
        "field": max_rel(res.field, oracle.field),
        "uncertainty": max_rel(
            res.uncertainty, oracle.uncertainty, variance**0.5
        ),
        "constraint_mask": max_rel(
            res.constraint_mask, oracle.constraint_mask, 1.0
        ),
    }
    for name, value in zip(res._fields, res):
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    bad = {k: v for k, v in errs.items() if not v <= KRIGING_TOL}
    if bad:
        raise AssertionError(f"{label}: f32 vs f64 beyond {KRIGING_TOL}: {bad}")
    return errs


def check(label, value, bound):
    if not value <= bound:
        raise AssertionError(f"{label}: {value:.3e} > {bound}")
    return value


def ptxas_summary(library, kernels):
    """{kernel: (most registers, spill bytes)} over the instantiations of
    each kernel, from the ``-Xptxas -v`` log nvcc wrote beside `library`."""
    from glomargridding_tpu_torch.ops.cuda import build

    text = build.library_path(library).with_suffix(".log").read_text()
    out = {k: [0, 0] for k in kernels}
    current = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)", line)
        if m:
            current = next((k for k in kernels if k in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current][0] = max(out[current][0], int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current][1] += int(m.group(1)) + int(m.group(2))
    return {k: tuple(v) for k, v in out.items()}


def band_pairs(P, hi, max_dist, group=16):
    """(pairs, kept) of K3's band: row block i against column blocks
    i..hi[i] (TILE points each, clipped to n), and those within the
    cutoff."""
    from glomargridding_tpu_torch.ops.cuda.ellipse import TILE, beyond_cutoff

    n = P.shape[0]
    hi_t = torch.as_tensor(np.asarray(hi, np.int64), device=P.device)
    block = torch.arange(n, device=P.device) // TILE
    starts = np.arange(len(hi)) * TILE
    pairs = sum((min(s + TILE, n) - s) * (min((int(h) + 1) * TILE, n) - s)
                for s, h in zip(starts, hi))
    kept = 0
    for g0 in range(0, len(hi), group):
        g1 = min(g0 + group, len(hi))
        r0, r1 = g0 * TILE, min(g1 * TILE, n)
        c1 = min((int(hi_t[g0:g1].max()) + 1) * TILE, n)
        mask = ~beyond_cutoff(P[r0:r1], P[r0:c1], max_dist)
        rb, cb = block[r0:r1, None], block[None, r0:c1]
        mask &= (cb >= rb) & (cb <= hi_t[rb])
        kept += int(mask.sum())
    return pairs, kept


def require_launches(label, count):
    if count == 0:
        raise AssertionError(f"the path launched no {label}")
    return count


def realistic_ellipse_params(glat, glon):
    """bench.py:574-608 (seed 42), as float32 numpy (Lx, Ly, theta,
    stdev): base scales ~900-1800 km with ~30% spatially correlated
    log-variation, rotated ellipses, and a rough stdev field."""
    rng = np.random.default_rng(42)
    la = np.radians(np.asarray(glat))
    lo = np.radians(np.asarray(glon))

    def rough(ncomp, scale):
        out = np.zeros_like(la)
        for _ in range(ncomp):
            k1, k2 = rng.integers(1, 7, size=2)
            s1, s2 = rng.choice([-1.0, 1.0], size=2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.normal()
            out += amp * np.sin(s1 * k1 * la + s2 * k2 * lo + ph)
        out /= np.sqrt(ncomp)
        return scale * out

    coslat = np.cos(la)
    Lx = (900.0 + 600.0 * coslat**2) * np.exp(0.35 * rough(12, 1.0))
    Ly = (600.0 + 300.0 * coslat) * np.exp(0.35 * rough(12, 1.0))
    theta = 0.4 * rough(12, 1.0)
    stdev = (0.8 + 0.4 * coslat) * np.exp(0.25 * rough(12, 1.0))
    return tuple(np.asarray(a, np.float32) for a in (Lx, Ly, theta, stdev))


def bench_fields(n):
    """bench.py:511-524's K2 inputs (seed 1), sorted by latitude (the
    grid compression order, so that a cutoff bands the matvec)."""
    rng = np.random.default_rng(1)
    lats = rng.uniform(-60.0, 60.0, n).astype(np.float32)
    lons = rng.uniform(-180.0, 180.0, n).astype(np.float32)
    Lx = rng.uniform(800.0, 1600.0, n).astype(np.float32)
    Ly = rng.uniform(400.0, 900.0, n).astype(np.float32)
    theta = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    stdev = rng.uniform(0.5, 1.5, n).astype(np.float32)
    order = np.argsort(lats, kind="stable")
    return lats[order], lons[order], tuple(
        a[order] for a in (Lx, Ly, theta, stdev))


def ellipse_args(lats, lons, fields, dtype, dev):
    """(lats_rad, lons_rad, sig_flat, sqrt_dets, stdevs) on the card."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov

    def on_card(a):
        return torch.as_tensor(a, device=dev).to(dtype)

    return tcov._ellipse_inputs(
        *(on_card(a) for a in fields),
        torch.deg2rad(on_card(lats)), torch.deg2rad(on_card(lons)))


def k3_band(P, max_dist):
    """K3's per-row-block band limits for lat-sorted points."""
    from glomargridding_tpu_torch.models.ellipse.covariance import (
        _stream_band_plan,
    )
    from glomargridding_tpu_torch.ops.cuda.ellipse import TILE

    lat = np.asarray(P[:, 0].cpu(), np.float64)
    n = lat.size
    return _stream_band_plan(lat, lat, n, n, max_dist, TILE, TILE)[2]


def builder_points(builder):
    """The packed points ``EllipseCovarianceBuilder`` hands K2."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda.ellipse import pack_points

    return pack_points(*tcov._ellipse_inputs(*builder._device_inputs()))


def core_outputs(core):
    """(field, uncertainty, mask) of a ``_simple_core``/``_ordinary_core``
    result, the uncertainty as the classes give it."""
    field, unc2, cmask = core[:3]
    return field, torch.sqrt(torch.clamp(unc2, min=0.0)), cmask


def kriging_errs(got, want, sd_scale):
    """(field, uncertainty, mask) against the same, as in phase 4: field
    relative to max |field|, uncertainty to sd_scale, mask absolute."""
    return {"field": max_rel(got[0], want[0]),
            "uncertainty": max_rel(got[1], want[1], sd_scale),
            "constraint_mask": max_rel(got[2], want[2], 1.0)}


def reset_ellipse_counts():
    for kernel in ("k2", "k3", "k4"):
        COUNTS[f"{kernel}.launches"] = 0


def solve_branches():
    """The dense kriging solves by branch since the last reset."""
    return {"cholesky": COUNTS["kriging.solve.cholesky"],
            "lu": COUNTS["kriging.solve.lu"]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    # every f32 product of the port feeds a solve or a cancellation
    precision = torch.get_float32_matmul_precision()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    if precision != "highest" or allow_tf32:
        raise SystemExit(f"chip_smoke: f32 matmul precision is {precision!r}"
                         f", allow_tf32={allow_tf32}: TF32 must be off")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    walled("1-2", device_and_build, precision, allow_tf32)
    glat, glon = grid_1deg()
    idx, y, err = observations(glat.size, dev)
    kernels = [walled("3-7", stationary_path, dev, glat, glon,
                      (idx, y, err))]
    kernels += walled("8-12", nonstationary, dev, glat, glon, (idx, y, err))
    launches = later_phases(dev, glat, glon, (idx, y, err))
    kernels.append(walled("32", phase32_fisher_z, dev))
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
    print("phase walls " + " ".join(f"{k}={v:.1f}s" for k, v in PHASE_WALLS
                                    .items())
          + f" total={time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


PHASE_WALLS = {}


def walled(label, fn, *args):
    """fn(*args), its wall kept under `label` in PHASE_WALLS."""
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    PHASE_WALLS[label] = time.perf_counter() - t0
    return out


def later_phases(dev, glat, glon, obs):
    """Phases 13-31; returns each kernel's launches on their paths."""
    launches = {"pairwise_tile": 0, "ellipse_sym": 0, "ellipse_matvec": 0,
                "ellipse_tile": 0, "ellipse_nll": 0}

    def add(**counts):
        for name, count in counts.items():
            launches[name] += count

    # phases 13-15 run K2 once more, for the repair's bf16 store, and
    # phase 17 once, on the fitted fields; phase 16's simplex runs on K5
    psd, k2_repair = walled("13-15", repaired_pipeline, dev, glat, glon,
                            obs)
    k2_fitted, k5_subset = walled("16-18", estimation_path, dev, glat, glon,
                                  psd)
    add(ellipse_sym=k2_repair + k2_fitted, ellipse_nll=k5_subset)
    walled("19", phase19_thresholds, dev, psd)
    # phase 22 launches K1 through kernel_matvec, phase 24 K2 once and
    # K5 in its fit
    k1_matvec, k2_pipeline, k5_pipeline = walled(
        "20-24", sampling_and_fitting, dev, glat, glon, obs)
    add(pairwise_tile=k1_matvec, ellipse_sym=k2_pipeline,
        ellipse_nll=k5_pipeline)
    # phases 25-27: K2 and K5 on the 5-degree workflow, K1 on the months
    # scan and the raw-observation kriging
    k1_host, k2_host, k5_host = walled("25-27", host_side_paths, dev)
    add(pairwise_tile=k1_host, ellipse_sym=k2_host, ellipse_nll=k5_host)
    # phase 28: the sharded paths; K1 in the kriging, K4 in the row
    # blocks, K3 and K4 in the stream and its clip, K5 in the lane split
    k1_shard, k3_shard, k4_shard, k5_shard = walled(
        "28", sharded_paths, dev, glat, glon, obs, psd)
    add(pairwise_tile=k1_shard, ellipse_matvec=k3_shard,
        ellipse_tile=k4_shard, ellipse_nll=k5_shard)
    del psd
    # phase 29: the 0.5-degree twin, K5 in its fit, K3 and K4 in its
    # stream and clip; phase 30: the 1-degree twins, K2's store, K1's
    # tiles, K4's build
    k3_quarter, k4_quarter, k5_quarter = walled(
        "29", phase29_quarter_degree, dev)
    k1_x, k2_x, k4_x = walled("30", phase30_examples, dev)
    add(pairwise_tile=k1_x, ellipse_sym=k2_x, ellipse_matvec=k3_quarter,
        ellipse_tile=k4_quarter + k4_x, ellipse_nll=k5_quarter)
    # phase 31: the 0.1-degree twin, K4 in its application and clip
    add(ellipse_tile=walled("31", phase31_tenth_degree, dev))
    return launches


def device_and_build(precision, allow_tf32):
    """Phases 1-2: the card, and K1-K4 built from the sources in this
    checkout, one nvcc each, all started together; no kernel may spill."""
    from glomargridding_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase(1, "device", torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), matmul_precision=precision,
          allow_tf32=allow_tf32)
    t0 = time.perf_counter()
    libraries = ("pairwise_tile", "ellipse_tile", "ellipse_nll")
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(build.load_library, libraries))
    phase(2, "build", seconds=f"{time.perf_counter() - t0:.1f}",
          libraries="|".join(build.library_path(n).name for n in libraries))
    # registers and spills (most registers over each kernel's
    # instantiations, their spill bytes summed); no kernel may spill
    ptxas = {**ptxas_summary("pairwise_tile", ["pairwise_tile_kernel"]),
             **ptxas_summary("ellipse_tile", [
                 "ellipse_sym_kernel", "ellipse_matvec_kernel",
                 "ellipse_tile_kernel"]),
             **ptxas_summary("ellipse_nll", ["fisher_z_nll_kernel"])}
    print("ptxas " + " ".join(f"{k}=regs:{r},spill_bytes:{b}"
                              for k, (r, b) in ptxas.items()), flush=True)
    for name in ptxas:
        if ptxas[name][1] != 0 or ptxas[name][0] == 0:
            raise AssertionError(f"{name}: ptxas reports {ptxas[name]}")


# the main path's K1 tiles: the 64.8k call's C_cross tiles (a full block
# and its last), the 259.2k call's last, a width with n % 4 != 0, and K
K1_SHAPES = {"5000x4096": slice(0, 4096), "5000x3360": slice(61440, 64800),
             "5000x1152": slice(0, 1152), "5000x4133": slice(7000, 11133),
             "5000x5000(K)": None}


def k1_case_err(la, lo, la_o, lo_o, dtype, nu, distance):
    """The worst K1 tile against its plain twin over K1_SHAPES, relative
    to the variance."""
    from glomargridding_tpu_torch import MaternVariogram
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        pairwise_covariance,
        pairwise_covariance_torch,
    )

    vario = MaternVariogram(psill=PSILL, nugget=0.05, range=RANGE_KM, nu=nu)
    worst = 0.0
    for label, cols in K1_SHAPES.items():
        rows = (la_o.to(dtype), lo_o.to(dtype))
        col = rows if cols is None else (la[cols].to(dtype),
                                         lo[cols].to(dtype))
        args = (*rows, *col, vario, distance)
        k = pairwise_covariance(*args)
        p = pairwise_covariance_torch(*args)
        sync()
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"non-finite K1 tile {label}")
        rel = max_rel(k, p, vario.psill + vario.nugget)
        if not rel <= TILE_RTOL[dtype]:
            raise AssertionError(f"K1 {dtype} nu={nu} {distance} {label}: "
                                 f"{rel:.3e} > {TILE_RTOL[dtype]}")
        worst = max(worst, rel)
    return worst


def phase3_k1_parity(la, lo, la_o, lo_o):
    """Phase 3: K1 against its plain twin at the main path's tile shapes,
    every order and distance; returns the main path's tile arguments and
    their max abs error."""
    from glomargridding_tpu_torch import MaternVariogram
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        DISTANCES,
        pairwise_covariance,
        pairwise_covariance_torch,
    )

    worst = {dtype: max(k1_case_err(la, lo, la_o, lo_o, dtype, nu, d)
                        for nu, d in product((0.5, 1.5, 2.5, 3.5),
                                             DISTANCES))
             for dtype in (torch.float32, torch.float64)}
    # the main path's own configuration, for the kernel report
    main_vario = MaternVariogram(psill=PSILL, range=RANGE_KM, nu=0.5)
    tile_args = (la_o, lo_o, la[:4096].contiguous(), lo[:4096].contiguous(),
                 main_vario, "haversine")
    main_abs_err = torch.max(torch.abs(
        pairwise_covariance(*tile_args) - pairwise_covariance_torch(*tile_args)
    )).item()
    phase(3, "k1_parity", shapes="|".join(K1_SHAPES), nus="0.5|1.5|2.5|3.5",
          distances="|".join(DISTANCES),
          f32_max_rel=f"{worst[torch.float32]:.3e}",
          f32_bound=TILE_RTOL[torch.float32],
          f64_max_rel=f"{worst[torch.float64]:.3e}",
          f64_bound=TILE_RTOL[torch.float64],
          main_f32_max_abs=f"{main_abs_err:.3e}")
    return tile_args, main_abs_err


def small_card_vs_cpu(kernel):
    """Phase 4's small f64 problem: the card (K1) against the CPU (the
    plain twin), over every output."""
    from glomargridding_tpu_torch import kriging_from_kernel

    rng = np.random.default_rng(SEED)
    s_lat = np.repeat(np.arange(-82.5, 90, 15.0), 24)
    s_lon = np.tile(np.arange(-172.5, 180, 15.0), 12)
    s_idx = np.sort(rng.choice(s_lat.size, 20, replace=False))
    s_obs = rng.normal(size=20)
    s_err = np.diag(0.1 + 0.05 * rng.random(20))
    small = [
        kriging_from_kernel(kernel, s_lat, s_lon, s_idx, s_obs, s_err,
                            variance=PSILL, n_blocks=3, device=d)
        for d in (torch.device("cuda"), "cpu")
    ]
    small_err = max(
        max_rel(a.cpu(), b) for a, b in zip(small[0], small[1])
    )
    if not small_err <= SMALL_RTOL:
        raise AssertionError(f"card vs CPU small f64: {small_err:.3e}")
    return small_err


def check_ensemble(members, field_e, ordinary, m):
    """Phase 5's checks: the ensemble's field against ordinary kriging,
    its shape, and its spread against variance x constraint mask."""
    field_err = max_rel(field_e, ordinary.field)
    if not field_err <= ENSEMBLE_FIELD_TOL:
        raise AssertionError(f"ensemble field vs ordinary: {field_err:.3e}")
    if members.shape != (N_MEMBERS, m) or not bool(
        torch.isfinite(members).all()
    ):
        raise AssertionError("ensemble members malformed")
    # each member's perturbation is simple-kriged unit noise through K, so
    # its variance at a cell is c' K^-1 c = variance * constraint mask
    spread = torch.var(members - field_e, dim=0).mean().item()
    expected = (PSILL * ordinary.constraint_mask).mean().item()
    if not 0.8 <= spread / expected <= 1.25:
        raise AssertionError(f"ensemble spread ratio {spread / expected:.3f}")
    return field_err, spread / expected


def stationary_path(dev, glat, glon, obs):
    """Phases 3-7, the main path: K1's parity, 64,800-cell kriging from
    5,000 observations against f64, the ensemble, 259,200 cells and the
    warm times; returns K1's entry of the kernel report."""
    from glomargridding_tpu_torch import (
        MaternVariogram,
        ensemble_from_kernel,
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        pairwise_covariance,
        pairwise_covariance_torch,
    )

    idx, y, err = obs
    m = glat.size
    la = torch.deg2rad(torch.as_tensor(glat, device=dev))
    lo = torch.deg2rad(torch.as_tensor(glon, device=dev))
    tile_args, main_abs_err = phase3_k1_parity(la, lo, la[idx], lo[idx])

    # 4. the main path: 64,800 cells x 5,000 observations
    kernel = variogram_kernel(MaternVariogram(psill=PSILL, range=RANGE_KM,
                                              nu=0.5), distance="haversine")
    glat_t = torch.as_tensor(glat, device=dev)
    glon_t = torch.as_tensor(glon, device=dev)

    def krige(method, dtype=torch.float32, lats=glat_t, lons=glon_t,
              obs=(idx, y, err), n_blocks=16):
        i, yy, e = obs
        return kriging_from_kernel(
            kernel, lats.to(dtype), lons.to(dtype), i, yy.to(dtype),
            error_cov=e.to(dtype), variance=PSILL, method=method,
            n_blocks=n_blocks,
        )

    COUNTS["k1.launches"] = 0
    ordinary = krige("ordinary")
    sync()
    main_launches = COUNTS["k1.launches"]
    if main_launches == 0:
        raise AssertionError("the main path launched no K1 tile")
    simple = krige("simple")
    errs_o = check_kriging(ordinary, krige("ordinary", torch.float64),
                           PSILL, "ordinary")
    errs_s = check_kriging(simple, krige("simple", torch.float64),
                           PSILL, "simple")
    if ordinary.field.shape != (m,):
        raise AssertionError(f"field shape {tuple(ordinary.field.shape)}")
    small_err = small_card_vs_cpu(kernel)
    phase(4, "kriging_64800x5000", k1_launches=main_launches,
          tol=KRIGING_TOL,
          **{f"ordinary_{k}": f"{v:.3e}" for k, v in errs_o.items()},
          **{f"simple_{k}": f"{v:.3e}" for k, v in errs_s.items()},
          small_card_vs_cpu_f64=f"{small_err:.3e}")

    # 5. the 100-member ensemble
    def ensemble():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ensemble_from_kernel(kernel, glat_t, glon_t, idx, y, err, gen,
                                    n_members=N_MEMBERS, n_blocks=16)

    field_e, members = ensemble()
    sync()
    field_err, spread_ratio = check_ensemble(members, field_e, ordinary, m)
    phase(5, "ensemble_100", field_vs_ordinary=f"{field_err:.3e}",
          tol=ENSEMBLE_FIELD_TOL, spread_ratio=f"{spread_ratio:.4f}")
    del members

    # 6. the 0.25-degree-class grid: 259,200 cells, 64 blocks
    q_lat, q_lon = grid_linspace(360, 720)
    q_glat = torch.as_tensor(q_lat, device=dev)
    q_glon = torch.as_tensor(q_lon, device=dev)
    q_obs = observations(q_lat.size, dev)

    def krige_quarter(dtype=torch.float32):
        return krige("ordinary", dtype, q_glat, q_glon, q_obs, n_blocks=64)

    quarter = krige_quarter()
    errs_q = check_kriging(quarter, krige_quarter(torch.float64), PSILL,
                           "259200")
    phase(6, "kriging_259200x5000", tol=KRIGING_TOL,
          **{k: f"{v:.3e}" for k, v in errs_q.items()})
    del quarter

    # 7. warm times
    k1_ms = cuda_time_ms(lambda: pairwise_covariance(*tile_args))
    plain_ms = cuda_time_ms(lambda: pairwise_covariance_torch(*tile_args))
    walls = {
        "kriging_64800_s": wall_median_s(lambda: krige("ordinary")),
        "kriging_simple_64800_s": wall_median_s(lambda: krige("simple")),
        "ensemble_100_s": wall_median_s(ensemble),
        "kriging_259200_s": wall_median_s(krige_quarter),
    }
    torch.cuda.reset_peak_memory_stats()
    krige("ordinary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_o = tile_args[0].numel()
    k1_pairs = n_o * 4096
    k1_points = n_o + 4096
    k1_bound, k1_by = bound(k1_pairs * 4 + k1_points * 2 * 4,
                            k1_pairs * K1_FLOPS,
                            k1_pairs * K1_TRANSCENDENTALS
                            + k1_points * K1_POINT_TRANSCENDENTALS)
    phase(7, "times", repeats=REPEATS, k1_5000x4096_ms=f"{k1_ms:.4f}",
          k1_bound_ms=f"{k1_bound:.4f}", k1_bound_by=k1_by,
          k1_share_of_bound=f"{k1_bound / k1_ms:.4f}",
          plain_5000x4096_ms=f"{plain_ms:.4f}",
          **{k: f"{v:.4f}" for k, v in walls.items()},
          kriging_64800_peak_gb=f"{peak_gb:.3f}")
    return {
        "name": "pairwise_tile",
        "route": "cuda",
        "source": "glomargridding_tpu_torch/ops/cuda/csrc/pairwise_tile.cu",
        "replaces": "glomargridding_tpu/ops/pallas/pairwise.py:106",
        "launches": main_launches,
        "max_abs_err": main_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }


def phase8_parity(dev, glat, glon):
    """K2, K3 and K4 against their plain twins over the orders, both
    displacement methods, with and without the cutoff, at ragged sizes."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    lats, lons, fields = bench_fields(N_RAGGED)
    pts = {}
    for dtype in (torch.float64, torch.float32):
        pts[dtype] = {
            n: te.pack_points(*ellipse_args(lats[:n], lons[:n],
                                            [f[:n] for f in fields], dtype,
                                            dev))
            for n in (N_SYM, N_RAGGED)
        }
    grid = {
        dtype: te.pack_points(*ellipse_args(
            glat, glon, realistic_ellipse_params(glat, glon), dtype, dev))
        for dtype in (torch.float64, torch.float32)
    }
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((N_RAGGED, te.MV_W), generator=gen, device=dev)
    worst = {k: 0.0 for k in ("k2_f64", "k2_f32", "k4_f64", "k4_f32",
                              "k3_twin", "k3_dense")}
    cases = list(product((0.5, 1.5, 2.5, 3.5), te.DELTA_X_METHODS,
                         (None, MAX_DIST_KM)))
    for dtype, (nu, method, md) in product((torch.float64, torch.float32),
                                           cases):
        tag = "f64" if dtype == torch.float64 else "f32"
        label = f"{tag} nu={nu} {method} max_dist={md}"
        args = (nu, method, md)
        worst["k2_" + tag] = max(worst["k2_" + tag], k2_k4_case(
            pts[dtype], args, label, ELLIPSE_RTOL[dtype]))
        band = grid[dtype][BAND_ROWS]
        rel = max_rel(te.ellipse_tile(band, grid[dtype], *args),
                      te.ellipse_tile_torch(band, grid[dtype], *args))
        worst["k4_" + tag] = max(worst["k4_" + tag], check(
            f"K4 2048x64800 {label}", rel, ELLIPSE_RTOL[dtype]))
        if dtype == torch.float32:
            twin, dense = k3_case(pts, x, args, label)
            worst["k3_twin"] = max(worst["k3_twin"], twin)
            worst["k3_dense"] = max(worst["k3_dense"], dense)
    k2_store_checks(pts[torch.float32][N_RAGGED])
    phase(8, "ellipse_kernels_parity", cases=len(cases) * 2,
          sizes=f"{N_SYM}|{N_RAGGED}|2048x{glat.size}",
          k2_eq_k4="bitwise", k2_symmetric="bitwise", bf16="rounded_once",
          **{k: f"{v:.3e}" for k, v in worst.items()},
          bounds=f"f64:{ELLIPSE_RTOL[torch.float64]}"
                 f"|f32:{ELLIPSE_RTOL[torch.float32]}"
                 f"|k3_twin:{K3_TWIN_TOL}|k3_dense:{K3_DENSE_TOL}")


def k2_k4_case(pts, args, label, rtol):
    """K2 against K4 (plus the diagonal) bitwise and K4 symmetric at each
    size; K2 against its plain twin at the ragged size (returned)."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    rel = 0.0
    for n, P in pts.items():
        k2 = te.ellipse_sym(P, *args)
        k4 = te.ellipse_tile(P, P, *args)
        k4.diagonal().add_(P[:, 6] * P[:, 6])
        sync()
        if not torch.equal(k2, k4):
            raise AssertionError(f"K2 != K4 bitwise, n={n}, {label}")
        if not torch.equal(k4, k4.T):
            raise AssertionError(f"K4 != K4' bitwise, n={n}, {label}")
        if n == N_RAGGED:
            rel = check(f"K2 {label}",
                        max_rel(k2, te.ellipse_sym_torch(P, *args)), rtol)
        del k2, k4
    return rel


def k3_case(pts, x, args, label):
    """K3 at the ragged size against its plain twin and against the dense
    f64 product: the two errors."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    P = pts[torch.float32][N_RAGGED]
    md = args[2]
    hi = None if md is None else k3_band(P, md)
    yk = te.ellipse_matvec(P, x, hi, *args)
    yp = te.ellipse_matvec_torch(P, x, hi, *args)
    dense = te.ellipse_sym(pts[torch.float64][N_RAGGED], *args)
    want = dense @ x.double()
    del dense
    diag_x = (P[:, 6] * P[:, 6])[:, None] * x
    return (check(f"K3 twin {label}", max_rel(yk, yp), K3_TWIN_TOL),
            check(f"K3 dense {label}", max_rel(yk + diag_x, want),
                  K3_DENSE_TOL))


def k2_store_checks(P):
    """The bf16 store is the f32 tile rounded once, its padding exact
    zeros; an order without a kernel raises before any launch."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    for md in (None, MAX_DIST_KM):
        kw = dict(add_diag=False, keep_pad=True)
        b16 = te.ellipse_sym(P, NU_NS, max_dist=md, out_dtype=torch.bfloat16,
                             **kw)
        f32 = te.ellipse_sym(P, NU_NS, max_dist=md, **kw)
        if not torch.equal(b16, f32.to(torch.bfloat16)):
            raise AssertionError("K2 bf16 is not the f32 tile rounded once")
        if bool(f32[N_RAGGED:].any()) or bool(f32[:, N_RAGGED:].any()):
            raise AssertionError("K2 keep_pad: nonzero padding")
        del b16, f32
    # an order without a kernel raises before any launch
    before = COUNTS["k2.launches"]
    try:
        te.ellipse_sym(P, 1.2)
    except ValueError as exc:
        if "half-integer" not in str(exc):
            raise
    else:
        raise AssertionError("nu = 1.2 did not raise")
    if COUNTS["k2.launches"] != before:
        raise AssertionError("a refused order launched")


def krige_nonstationary(dev, glat, glon, obs, nu):
    """EllipseCovarianceBuilder (K2) + dense kriging at 1 degree for one
    order, held against its plain twin and two f64 oracles:

    - K2 at the builder's size: a row band of the matrix against the
      plain tile of the builder's own points, to ELLIPSE_RTOL;
    - the matrix: the blocks kriging reads, C[idx, :] (C[idx, idx] is
      inside it), against K4 in f64. Every entry must agree to
      COVARIANCE_TOL except at pairs exactly 180 degrees apart in
      longitude: there the reference's +-pi wrap of dx is a step, and
      f32 and f64 may land on its two sides (dx = +pi or -pi flips the
      sign of the quadratic form's cross term);
    - the solves: the same solves in f64 on the builder's own matrix, to
      DENSE_KRIGING_TOL[nu]; the faults of DENSE_FAULTS, read the same
      way, must exceed it. Cross-validation is held where K is positive
      definite (an indefinite K has negative LOO variances).
    """
    from glomargridding_tpu_torch import (
        EllipseCovarianceBuilder,
        OrdinaryKriging,
        SimpleKriging,
        crossval_from_covariance,
    )
    from glomargridding_tpu_torch.models.kernel_kriging import _loo_from_K
    from glomargridding_tpu_torch.models.kriging import (
        _ordinary_core,
        _simple_core,
    )
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    idx, y, err = obs
    fields = realistic_ellipse_params(glat, glon)
    lat_axis, lon_axis = np.unique(glat), np.unique(glon)
    shape = (lat_axis.size, lon_axis.size)

    reset_ellipse_counts()
    COUNTS["kriging.solve.cholesky"] = COUNTS["kriging.solve.lu"] = 0
    torch.cuda.reset_peak_memory_stats()
    # no device named: the builder runs on the card by default
    builder = EllipseCovarianceBuilder(
        *(f.reshape(shape) for f in fields), lat_axis, lon_axis, v=nu,
    )
    cov = builder.cov_ns
    if not cov.is_cuda:
        raise AssertionError(f"the builder ran on {cov.device}")
    ok = OrdinaryKriging(cov, idx, y, err)
    res = {"ordinary": (ok.solve(), ok.get_uncertainty(),
                        ok.constraint_mask())}
    sk = SimpleKriging(cov, idx, y, err)
    res["simple"] = (sk.solve(), sk.get_uncertainty(), sk.constraint_mask())
    cv = crossval_from_covariance(cov, idx, y, err)
    sync()
    out = {"k2_launches": require_launches("K2 (builder)",
                                           COUNTS["k2.launches"]),
           "branches": solve_branches(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cov.shape != (glat.size, glat.size) or cov.dtype != torch.float32:
        raise AssertionError(f"covariance {tuple(cov.shape)} {cov.dtype}")
    for method, outs in res.items():
        for got in outs:
            if got.shape != (glat.size,) or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError(f"{method}: malformed output")
    # K2 at 64,800 against its plain twin on a row band
    P = builder_points(builder)
    band = P[BAND_ROWS]
    plain = te.ellipse_tile_torch(band, P, nu)
    plain[torch.arange(band.shape[0], device=dev),
          torch.arange(BAND_ROWS.start, BAND_ROWS.stop, device=dev)] += (
        band[:, 6] * band[:, 6])
    errs = {"k2_band_vs_plain": max_rel(cov[BAND_ROWS], plain)}
    del P, band, plain
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out["x8"] = torch.randn((glat.size, 8), generator=gen, device=dev)
    out["y_dense"] = cov @ out["x8"]
    Cc = cov[idx, :].double()
    C_diag = torch.diagonal(cov).double()
    del builder, cov, ok, sk

    # the matrix against K4 in f64 (zero self-pairs, then stdev^2)
    P = te.pack_points(*ellipse_args(glat, glon, fields, torch.float64, dev))
    Cc64 = te.ellipse_tile(P[idx], P, nu)
    Cc64[torch.arange(idx.numel(), device=dev), idx] += P[idx, 6] ** 2
    lon = torch.as_tensor(glon, device=dev).double()
    antimeridian = torch.abs(lon[idx][:, None] - lon[None, :]) == 180.0
    scale = torch.max(torch.abs(Cc64)).item()
    dev_rel = torch.abs(Cc - Cc64) / scale
    errs["covariance"] = torch.max(dev_rel[~antimeridian]).item()
    errs["covariance_antimeridian"] = torch.max(dev_rel[antimeridian]).item()
    del Cc64, P, dev_rel, antimeridian
    # the solves in f64 on the builder's own matrix
    err64 = err.double()
    K = Cc[:, idx] + err64
    eig = torch.linalg.eigvalsh(K)
    cond = (eig.abs().max() / eig.abs().min()).item()
    y64 = y.double()
    oracle = {
        "ordinary": core_outputs(_ordinary_core(K, Cc, C_diag, y64)),
        "simple": core_outputs(_simple_core(K, Cc, C_diag, y64, 0.0)),
    }
    sd_scale = float(torch.sqrt(C_diag.max()))
    for method, got in res.items():
        for k, v in kriging_errs(got, oracle[method], sd_scale).items():
            errs[f"{method}_{k}"] = v
    spd = eig[0].item() > 0.0
    if spd:
        cv64 = _loo_from_K(K, y64, 0.0, "ordinary")
        for name, got, want in zip(cv._fields, cv, cv64):
            errs[f"crossval_{name}"] = max_rel(got, want)
    # negative controls: each fault's largest reading on the same scales
    wrong = {
        "simple_for_ordinary": oracle["simple"],
        "error_cov_x1.1": core_outputs(_ordinary_core(
            Cc[:, idx] + 1.1 * err64, Cc, C_diag, y64)),
    }
    faults = {name: max(kriging_errs(got, oracle["ordinary"],
                                     sd_scale).values())
              for name, got in wrong.items()}
    out.update(errs=errs, faults=faults, eig_min=eig[0].item(),
               eig_max=eig[-1].item(), cond=cond, spd=spd)
    return out


def phase9_dense_kriging(dev, glat, glon, obs):
    """Non-stationary dense kriging at 1 degree: nu = 1.5 (the slice's
    configuration; its K is indefinite) and nu = 0.5 (HadSST4's order;
    positive definite)."""
    runs = {}
    for nu in (0.5, NU_NS):  # the nu = 1.5 run's tensors feed phase 10
        r = krige_nonstationary(dev, glat, glon, obs, nu)
        runs[nu] = r
        br = r["branches"]
        phase(9, f"ellipse_dense_kriging_64800x5000_nu{nu}",
              covariance_gb=f"{glat.size**2 * 4 / 1e9:.1f}",
              k2_launches=r["k2_launches"],
              solve_branches=f"cholesky:{br['cholesky']}|lu:{br['lu']}",
              K_eig_min=f"{r['eig_min']:.4g}",
              K_eig_max=f"{r['eig_max']:.4g}", K_cond=f"{r['cond']:.3g}",
              k2_tol=ELLIPSE_RTOL[torch.float32],
              covariance_tol=COVARIANCE_TOL, tol=DENSE_KRIGING_TOL[nu],
              peak_gb=f"{r['peak_gb']:.3f}",
              **{k: f"{v:.3e}" for k, v in r["errs"].items()},
              **{f"fault_{k}": f"{v:.3e}" for k, v in r["faults"].items()})
    for nu, r in runs.items():
        errs = dict(r["errs"])
        errs.pop("covariance_antimeridian")
        check(f"nu={nu} K2 64800 band vs plain", errs.pop("k2_band_vs_plain"),
              ELLIPSE_RTOL[torch.float32])
        check(f"nu={nu} builder covariance f32 vs K4 f64 (off the "
              "antimeridian)", errs.pop("covariance"), COVARIANCE_TOL)
        tol = DENSE_KRIGING_TOL[nu]
        for k, v in errs.items():
            check(f"nu={nu} ellipse kriging {k} f32 vs f64", v, tol)
        for k in DENSE_FAULTS:
            if not r["faults"][k] > tol:
                raise AssertionError(
                    f"nu={nu}: the bound {tol} passes the fault {k} "
                    f"({r['faults'][k]:.3e})")
    if not runs[0.5]["spd"] or runs[0.5]["branches"]["cholesky"] == 0:
        raise AssertionError("nu = 0.5: expected a positive definite K")
    r = runs[NU_NS]
    return r["x8"], r["y_dense"], sum(x["k2_launches"] for x in runs.values())


def phase10_bf16_operator(dev, glat, glon, x8, y_dense):
    """The bf16 store at 64,800 (K2), one 8-column application."""
    from glomargridding_tpu_torch import ellipse_covariance_operator
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    args = ellipse_args(glat, glon, realistic_ellipse_params(glat, glon),
                        torch.float32, dev)
    reset_ellipse_counts()
    mv, n, trace = ellipse_covariance_operator(*args, v=NU_NS, store="bf16")
    y = mv(x8)
    sync()
    k2_launches = require_launches("K2 (bf16 store)", COUNTS["k2.launches"])
    if y.shape != (n, 8) or y.dtype != torch.float32:
        raise AssertionError(f"bf16 matvec {tuple(y.shape)} {y.dtype}")
    rel = check("bf16 matvec vs dense f32", max_rel(y, y_dense), BF16_TOL)
    store_gb = (-(-n // te.TILE) * te.TILE) ** 2 * 2 / 1e9
    phase(10, "bf16_operator_64800", store_gb=f"{store_gb:.2f}",
          k2_launches=k2_launches, trace=f"{trace:.6g}",
          max_rel_vs_dense_f32=f"{rel:.3e}", bound=BF16_TOL)
    return k2_launches


def phase11_stream(dev):
    """The banded stream operator at 259,200 cells: 8 columns through K3,
    1,024 through K4 + GEMM, K3 against the wide path, and banded against
    the unbanded stream with the same cutoff."""
    from glomargridding_tpu_torch import ellipse_covariance_operator
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    q_lat, q_lon = grid_linspace(*STREAM_GRID)
    args = ellipse_args(q_lat, q_lon, realistic_ellipse_params(q_lat, q_lon),
                        torch.float32, dev)
    n = q_lat.size
    rng = np.random.default_rng(5)
    x8 = torch.as_tensor(rng.normal(size=(n, 8)).astype(np.float32),
                         device=dev)
    x1k = torch.as_tensor(
        rng.normal(size=(n, WIDE_COLS)).astype(np.float32), device=dev)

    reset_ellipse_counts()
    torch.cuda.reset_peak_memory_stats()
    mv, _, _ = ellipse_covariance_operator(*args, v=NU_NS, store="stream",
                                           max_dist=MAX_DIST_KM)
    y8 = mv(x8)
    y1k = mv(x1k)
    sync()
    launches = {
        "k3": require_launches("K3 (narrow stream)",
                               COUNTS["k3.launches"]),
        "k4": require_launches("K4 (wide stream)", COUNTS["k4.launches"]),
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, y, w in (("y8", y8, 8), ("y1024", y1k, WIDE_COLS)):
        if y.shape != (n, w) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"stream {name} malformed")
    del y1k
    # the same 8 columns through the wide path (a 9th, zero column)
    y9 = mv(torch.cat([x8, torch.zeros_like(x8[:, :1])], dim=1))[:, :8]
    k3_vs_wide = check("K3 vs wide", max_rel(y8, y9), STREAM_ORDER_TOL)
    # banded against the unbanded stream (every tile built, same cutoff)
    P = te.pack_points(*args)
    x16 = x1k[:, :16]
    block = tcov._block_rows(n, None)
    full = tcov._row_windows(n, block, [0] * -(-n // block), n)
    unbanded = tcov._apply_wide(P, x16, full, NU_NS, "Modified_Met_Office",
                                MAX_DIST_KM) + (P[:, 6] ** 2)[:, None] * x16
    banded_vs_dense = check("banded vs unbanded", max_rel(mv(x16), unbanded),
                            STREAM_ORDER_TOL)
    stats = mv.band_stats
    phase(11, "stream_operator_259200", max_dist_km=MAX_DIST_KM,
          k3_launches=launches["k3"], k4_launches=launches["k4"],
          bw=stats["bw"], wide_pairs=stats["wide_pairs"],
          fused_pairs=stats["fused_pairs"], k3_vs_wide=f"{k3_vs_wide:.3e}",
          banded_vs_unbanded=f"{banded_vs_dense:.3e}",
          bound=STREAM_ORDER_TOL, peak_gb=f"{peak_gb:.3f}")
    return launches, (P, x8, x1k, mv, block)


def phase12_times(dev, glat, glon, obs, stream):
    """Kernel times against their plain twins (CUDA events), their bounds
    from this run's inputs, and the non-stationary walls (median of warm
    runs)."""
    from glomargridding_tpu_torch import OrdinaryKriging
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    idx, y, err = obs
    out = {}
    lats, lons, fields = bench_fields(N_SYM)
    P = te.pack_points(*ellipse_args(lats, lons, fields, torch.float32, dev))
    abs_err = {"k2": torch.max(torch.abs(
        te.ellipse_sym(P, NU_NS) - te.ellipse_sym_torch(P, NU_NS))).item()}
    out["k2_16384_ms"] = cuda_time_ms(lambda: te.ellipse_sym(P, NU_NS))
    out["k2_plain_16384_ms"] = cuda_time_ms(
        lambda: te.ellipse_sym_torch(P, NU_NS), iters=3)
    # K2 stores all n^2 values and needs each distinct pair's value once
    # (no cutoff here)
    bounds = {"k2_16384": ellipse_bound(
        N_SYM * N_SYM * 4 + N_SYM * 64, 0, N_SYM * (N_SYM - 1) // 2)}

    P = te.pack_points(*ellipse_args(
        glat, glon, realistic_ellipse_params(glat, glon), torch.float32, dev))
    out["k2_64800_f32_ms"] = cuda_time_ms(lambda: te.ellipse_sym(P, NU_NS),
                                          iters=3)
    C = te.ellipse_sym(P, NU_NS)

    def krige():
        ok = OrdinaryKriging(C, idx, y, err)
        return ok.solve(), ok.get_uncertainty(), ok.constraint_mask()

    out["ordinary_kriging_64800_s"] = wall_median_s(krige)
    del C
    out["k2_64800_bf16_ms"] = cuda_time_ms(
        lambda: te.ellipse_sym(P, NU_NS, out_dtype=torch.bfloat16,
                               add_diag=False, keep_pad=True), iters=3)
    m = P.shape[0]
    m_pad = -(-m // te.TILE) * te.TILE
    bounds["k2_64800_f32"] = ellipse_bound(m * m * 4 + m * 64, 0,
                                           m * (m - 1) // 2)
    bounds["k2_64800_bf16"] = ellipse_bound(m_pad * m_pad * 2 + m * 64, 0,
                                            m * (m - 1) // 2)

    P, x8, x1k, mv, block = stream
    n = P.shape[0]
    lat = np.asarray(P[:, 0].cpu(), np.float64)
    lat_pad = np.pad(lat, (0, -(-n // block) * block - n), mode="edge")
    col_starts, bw, hi = tcov._stream_band_plan(
        lat_pad, lat, n, block, MAX_DIST_KM, te.TILE, te.TILE)
    r0 = (n // 2) // block * block  # a row block at the equator
    c0 = int(col_starts[r0 // block])
    rows, cols = P[r0:r0 + block], P[c0:min(c0 + bw, n)]
    tile_args = (rows, cols, NU_NS, "Modified_Met_Office", MAX_DIST_KM)
    plain = te.ellipse_tile_torch(*tile_args)
    k4 = te.ellipse_tile(*tile_args)
    abs_err["k4"] = torch.max(torch.abs(k4 - plain)).item()
    rel = {"k4_vs_plain": check("K4 stream tile vs plain", max_rel(k4, plain),
                                ELLIPSE_RTOL[torch.float32])}
    # the wide stream's row block (K4 + GEMM) against the plain tile's
    # product with the same 16 columns
    x16 = x1k[:, :16]
    want = plain @ x16[c0:c0 + cols.shape[0]] + (
        rows[:, 6] * rows[:, 6])[:, None] * x16[r0:r0 + block]
    rel["wide_block_vs_plain"] = check(
        "wide stream row block vs plain", max_rel(mv(x16)[r0:r0 + block], want),
        STREAM_ORDER_TOL)
    del k4, plain, want
    out["k4_tile_shape"] = f"{rows.shape[0]}x{cols.shape[0]}"
    out["k4_tile_ms"] = cuda_time_ms(lambda: te.ellipse_tile(*tile_args))
    out["k4_plain_tile_ms"] = cuda_time_ms(
        lambda: te.ellipse_tile_torch(*tile_args), iters=3)
    k4_pairs = rows.shape[0] * cols.shape[0]
    k4_kept = int((~te.beyond_cutoff(rows, cols, MAX_DIST_KM)).sum())
    out["k4_kept_share"] = k4_kept / k4_pairs
    bounds["k4_tile"] = ellipse_bound(
        k4_pairs * 4 + (rows.shape[0] + cols.shape[0]) * 64, k4_pairs,
        k4_kept)
    mv_args = (P, x8, hi, NU_NS, "Modified_Met_Office", MAX_DIST_KM)
    yk = te.ellipse_matvec(*mv_args)
    yp = te.ellipse_matvec_torch(*mv_args)
    abs_err["k3"] = torch.max(torch.abs(yk - yp)).item()
    rel["k3_vs_plain"] = check("K3 259200 vs plain", max_rel(yk, yp),
                               K3_TWIN_TOL)
    del yk, yp
    out["k3_259200_ms"] = cuda_time_ms(lambda: te.ellipse_matvec(*mv_args),
                                       iters=5)
    out["k3_plain_259200_ms"] = cuda_time_ms(
        lambda: te.ellipse_matvec_torch(*mv_args), iters=1)
    k3_pairs, k3_kept = band_pairs(P, hi, MAX_DIST_KM)
    out["k3_band_pairs"] = str(k3_pairs)
    out["k3_kept_share"] = k3_kept / k3_pairs
    # points read, x read and y written, each MV_W wide
    bounds["k3_259200"] = ellipse_bound(n * 64 + 2 * n * te.MV_W * 4,
                                        k3_pairs, k3_kept, K3_CONTRACT_FLOPS)
    timed = {"k2_16384": "k2_16384_ms", "k2_64800_f32": "k2_64800_f32_ms",
             "k2_64800_bf16": "k2_64800_bf16_ms", "k4_tile": "k4_tile_ms",
             "k3_259200": "k3_259200_ms"}
    for key, (bound_ms, bound_by) in bounds.items():
        out[f"{key}_bound_ms"] = bound_ms
        out[f"{key}_bound_by"] = bound_by
        out[f"{key}_share_of_bound"] = bound_ms / out[timed[key]]
    out["stream_mv8_259200_s"] = wall_median_s(lambda: mv(x8))
    out["stream_mv1024_259200_s"] = wall_median_s(lambda: mv(x1k))
    out["stream_mv1024_259200_window_s"] = window_wall_s(mv, P, x1k,
                                                         MAX_DIST_KM)
    out["stream_block_rows"] = str(mv.band_stats["block"])
    phase(12, "ellipse_times", repeats=REPEATS,
          **{k: v if isinstance(v, str) else f"{v:.4f}"
             for k, v in out.items()},
          **{k: f"{v:.3e}" for k, v in rel.items()},
          bounds=f"k4:{ELLIPSE_RTOL[torch.float32]}|wide:{STREAM_ORDER_TOL}"
                 f"|k3:{K3_TWIN_TOL}")
    return out, abs_err, bounds


def window_wall_s(mv, P, x, max_dist):
    """The wall of `mv`'s wide application of x with every row block
    against its whole window (``_apply_wide`` without the certificate's
    chunks), the diagonal added: what the certificate's gather replaced."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov

    lat = P[:, 0].double().cpu().numpy()
    windows = tcov.stream_plan(lat, lat, mv.band_stats["block"],
                               max_dist)[0]
    diag = (P[:, 6].float() ** 2)[:, None]
    return wall_median_s(lambda: tcov._apply_wide(
        P, x, windows, NU_NS, "Modified_Met_Office", max_dist) + diag * x)


def nonstationary(dev, glat, glon, obs):
    """Phases 8-12; returns the kernel report entries of K2, K3, K4."""
    phase8_parity(dev, glat, glon)
    x8, y_dense, k2_builder = phase9_dense_kriging(dev, glat, glon, obs)
    k2_store = phase10_bf16_operator(dev, glat, glon, x8, y_dense)
    del x8, y_dense
    launches, stream = phase11_stream(dev)
    times, abs_err, bounds = phase12_times(dev, glat, glon, obs, stream)
    source = "glomargridding_tpu_torch/ops/cuda/csrc/ellipse_tile.cu"
    replaced = "glomargridding_tpu/ops/pallas/pairwise.py:"
    # no single PyTorch call computes an ellipse pair function
    # K2 at the path's size, 64,800: the f32 build (ms, bound) and the bf16
    # store (bf16_*); the plain twin cannot hold 64,800^2 intermediates, so
    # its time and the error are read at 16,384 (plain_shape)
    rows = (("ellipse_sym", "423", k2_builder + k2_store, "k2",
             "k2_64800_f32", "k2_64800_f32_ms", "k2_plain_16384_ms"),
            ("ellipse_matvec", "648", launches["k3"], "k3", "k3_259200",
             "k3_259200_ms", "k3_plain_259200_ms"),
            ("ellipse_tile", "265", launches["k4"], "k4", "k4_tile",
             "k4_tile_ms", "k4_plain_tile_ms"))
    entries = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaced + line, "launches": count,
         "max_abs_err": abs_err[err], "ms": times[ms],
         "plain_ms": times[plain], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1], "library_ms": None}
        for name, line, count, err, key, ms, plain in rows
    ]
    entries[0].update(
        shape="64800 f32 build", plain_shape="16384",
        bf16_shape="64832 bf16 store", bf16_ms=times["k2_64800_bf16_ms"],
        bf16_bound_ms=bounds["k2_64800_bf16"][0],
        bf16_bound_by=bounds["k2_64800_bf16"][1])
    return entries


class Stopwatch:
    """A function with its calls counted and timed on the host's clock
    around device synchronisation; `log` keeps (first argument's leading
    size, or 0 where it has none, seconds) of every call."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls, self.log = fn, 0.0, 0, []

    def __call__(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        sync()
        dt = time.perf_counter() - t0
        self.seconds += dt
        self.calls += 1
        size = args[0].shape[0] if hasattr(args[0], "shape") else 0
        self.log.append((int(size), dt))
        return out


class SolverLog(logging.Handler):
    """What ``adaptive_topk_eigh`` logged: the gate its last candidate
    passed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.accepted = "none"

    def emit(self, record):
        if "structural accept" in record.msg:
            self.accepted = "structural"
        elif "max_resid/theta1" in record.msg:
            self.accepted = f"{record.args[3]:.3e}"


@contextmanager
def solver_log():
    """What ``adaptive_topk_eigh`` logs while the block runs, as a
    ``SolverLog``."""
    from glomargridding_tpu_torch.ops import eigsh

    log = SolverLog()
    level, propagate = eigsh.logger.level, eigsh.logger.propagate
    eigsh.logger.addHandler(log)
    eigsh.logger.setLevel(logging.INFO)
    eigsh.logger.propagate = False  # the records are for `log` alone
    try:
        yield log
    finally:
        eigsh.logger.removeHandler(log)
        eigsh.logger.setLevel(level)
        eigsh.logger.propagate = propagate


def solver_counts(before):
    """The eigensolver's counters since the snapshot `before` of
    ``COUNTS``: operator applications (sweeps), stages (one more than
    the widenings) and the columns the applications carried."""
    def delta(name):
        return COUNTS[name] - before[name]

    return {"sweeps": delta("eigsh.applications"),
            "stages": delta("eigsh.widenings") + 1,
            "columns": delta("eigsh.columns")}


def clip_instrumented(mv, n, trace, clip=None, spans=False):
    """One clip of the operator, counted from ``COUNTS``, with its wall
    around device synchronisation. With `spans`, under ``torch.profiler``
    with the port's spans on: the device seconds launched inside its
    sweeps, CholQR2 passes and Rayleigh-Ritz projections and ``eigh``
    (``eigsh.sweep``, ``eigsh.cholqr``, ``eigsh.ritz``; the profiler slows
    the run against the warm ones). Without, the operator handed in is a
    ``Stopwatch``: its applications' seconds, each synchronised. `clip(op)`
    runs the clip on the operator (default: phase 13's); its result comes
    back first, then the split (a dict), the solver's log and the wall."""
    from glomargridding_tpu_torch import explained_variance_clip_lowrank
    from glomargridding_tpu_torch.utils.profiling import span_device_seconds

    if clip is None:
        def clip(op):
            return explained_variance_clip_lowrank(
                op, n=n, trace=trace, target_variance_fraction=CLIP_TARGET,
                **CLIP_KW)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    before = COUNTS.copy()
    op = mv if spans else Stopwatch(mv)
    with ExitStack() as stack:
        log = stack.enter_context(solver_log())
        if spans:
            stack.enter_context(spans_on())
            prof = stack.enter_context(torch.profiler.profile(
                activities=activities))
        sync()
        t0 = time.perf_counter()
        psd = clip(op)
        sync()
        total = time.perf_counter() - t0
    split = solver_counts(before)
    if spans:
        device = span_device_seconds(prof)
        for name in ("sweep", "cholqr", "ritz"):
            split[f"{name}_s"] = device.get(f"eigsh.{name}", 0.0)
    else:
        split["sweep_s"] = op.seconds
    return psd, split, log, total


def eigh_f64_seconds(n, dev):
    a = torch.randn((n, n), dtype=torch.float64, device=dev)
    a = a + a.T
    sync()
    t0 = time.perf_counter()
    torch.linalg.eigh(a)
    sync()
    return time.perf_counter() - t0


def sub_problem_checks(dev):
    """The partial clip against the full spectrum on a K2-built f32
    matrix of bench.py:511-524's fields; `eig_min` says whether it is
    indefinite."""
    from glomargridding_tpu_torch import (
        explained_variance_clip,
        explained_variance_clip_lowrank,
    )
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    eigh_f64_seconds(1024, dev)  # the solver library's start-up
    t4096 = eigh_f64_seconds(4096, dev)
    n_sub = max((c for c in SUB_SIZES
                 if t4096 * (c / 4096) ** 3 <= SUB_EIGH_BUDGET_S),
                default=SUB_SIZES[-1])
    lats, lons, fields = bench_fields(n_sub)
    P = te.pack_points(*ellipse_args(lats, lons, fields, torch.float32, dev))
    C = te.ellipse_sym(P, NU_NS)
    scale = torch.max(torch.abs(C)).item()
    C64 = C.double()
    sync()
    t0 = time.perf_counter()
    w_full = torch.linalg.eigvalsh(C64).flip(0)
    sync()
    eigvalsh_s = time.perf_counter() - t0

    psd = explained_variance_clip_lowrank(
        C, target_variance_fraction=CLIP_TARGET, **CLIP_KW)
    r = psd.effective_rank
    ritz = psd.gains[:r].double() + psd.floor[0].double()
    out = {"n": n_sub, "eigh_4096_s": t4096, "eigvalsh_s": eigvalsh_s,
           "eig_min": w_full[-1].item(), "theta_1": w_full[0].item(),
           "rank": psd.rank, "effective_rank": r,
           "ritz_vs_full": torch.max(torch.abs(ritz - w_full[:r])).item()
           / w_full[0].item()}
    del psd

    t0 = time.perf_counter()
    full = explained_variance_clip(C64, CLIP_TARGET, spectrum="full")
    sync()
    out["full_clip_s"] = time.perf_counter() - t0
    del C64
    for name, target in (("partial_vs_full", CLIP_TARGET),
                         ("wrong_target_vs_full", CLIP_WRONG_TARGET)):
        partial = explained_variance_clip(C, target, spectrum="partial",
                                          **CLIP_KW)
        if partial.shape != full.shape or partial.device.type != dev.type:
            raise AssertionError(f"partial clip {tuple(partial.shape)}")
        out[name] = max_rel(partial, full, scale)
        del partial
    return out


def phase13_psd_repair(dev, glat, glon):
    """The bf16 operator at 64,800 (K2) through the trace-preserving
    low-rank clip; returns (psd, K2 launches)."""
    from glomargridding_tpu_torch import (
        LowRankPSD,
        ellipse_covariance_operator,
        explained_variance_clip_lowrank,
    )

    args = ellipse_args(glat, glon, realistic_ellipse_params(glat, glon),
                        torch.float32, dev)
    reset_ellipse_counts()
    torch.cuda.reset_peak_memory_stats()
    mv, n, trace = ellipse_covariance_operator(*args, v=NU_NS, store="bf16")
    # the warm walls first, so that the instrumented run's split is warm
    warm = wall_median_s(lambda: explained_variance_clip_lowrank(
        mv, n=n, trace=trace, target_variance_fraction=CLIP_TARGET,
        **CLIP_KW))
    psd, split, log, total = clip_instrumented(mv, n, trace, spans=True)
    k2_launches = require_launches("K2 (the repair's bf16 store)",
                                   COUNTS["k2.launches"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not isinstance(psd, LowRankPSD) or (
            psd.vectors.device.type != dev.type
            or psd.vectors.dtype != torch.float32 or psd.n != n):
        raise AssertionError("the clip did not return f32 factors on the card")
    if psd.rank % CLIP_KW["rank_multiple"] or not bool(
            torch.isfinite(psd.vectors).all()):
        raise AssertionError(f"factors malformed, rank {psd.rank}")
    if not float(psd.gains.min()) >= 0.0 or not float(psd.floor.min()) > 0.0:
        raise AssertionError("gains must be >= 0 and the floor > 0")
    trace_rel = check("trace of the factors vs the operator's",
                      abs(psd.trace() - trace) / trace, TRACE_TOL)
    del mv
    sub = sub_problem_checks(dev)
    phase(13, "psd_repair_64800", k2_launches=k2_launches,
          target=CLIP_TARGET, rank=psd.rank,
          effective_rank=psd.effective_rank,
          stages=split["stages"], sweeps=split["sweeps"],
          columns=split["columns"], final_resid_over_theta1=log.accepted,
          trace=f"{trace:.6g}", trace_rel=f"{trace_rel:.3e}",
          trace_tol=TRACE_TOL, floor=f"{float(psd.floor[0]):.4g}",
          instrumented_s=f"{total:.3f}",
          sweeps_s=f"{split['sweep_s']:.3f}",
          cholqr_s=f"{split['cholqr_s']:.3f}",
          ritz_s=f"{split['ritz_s']:.3f}",
          clip_warm_s=f"{warm:.4f}", repeats=REPEATS,
          peak_gb=f"{peak_gb:.3f}",
          **{f"sub_{k}": v if isinstance(v, int) else f"{v:.4g}"
             for k, v in sub.items()},
          sub_tol=SUB_TOL)
    check("sub-problem: retained Ritz values vs the full f64 spectrum",
          sub["ritz_vs_full"], SUB_TOL)
    check("sub-problem: partial clip vs full clip", sub["partial_vs_full"],
          SUB_TOL)
    if not sub["wrong_target_vs_full"] > SUB_TOL:
        raise AssertionError(
            f"the bound {SUB_TOL} passes a clip at the wrong target "
            f"({sub['wrong_target_vs_full']:.3e})")
    return psd, k2_launches


def check_lowrank_outputs(res, members, n, dev):
    """Phase 14's outputs: n wide, on the card, finite; the members'
    shape."""
    for name, got in (*zip(res._fields, res), ("members", members)):
        if got.shape[-1] != n or got.device.type != dev.type or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"lowrank {name} malformed")
    if members.shape != (N_MEMBERS, n):
        raise AssertionError(f"members {tuple(members.shape)}")


def lowrank_consistency(psd, idx, e, gen):
    """Self-consistency (bench.py:698-724): a truth drawn from the
    factored covariance, observed with the error covariance's own noise,
    kriged with 100 members: RMSE, mean uncertainty and member spread."""
    from glomargridding_tpu_torch import lowrank_ensemble_step

    truth = psd.draw(1, generator=gen)[0]
    yc = truth[idx] + torch.sqrt(e) * torch.randn(
        idx.numel(), generator=gen, device=truth.device)
    res_c, mem_c = lowrank_ensemble_step(psd, idx, yc, e, gen, N_MEMBERS)
    return {
        "rmse": torch.sqrt(torch.mean((res_c.field - truth) ** 2)).item(),
        "mean_uncertainty": res_c.uncertainty.mean().item(),
        "member_spread": (mem_c - res_c.field).std(dim=0).mean().item(),
    }


def phase14_lowrank_kriging(dev, psd, obs):
    """Kriging, ensemble and cross-validation off the padded factors,
    against f64, the dense-E route and the dense classes."""
    from glomargridding_tpu_torch import (
        LowRankPSD,
        OrdinaryKriging,
        lowrank_crossval,
        lowrank_ensemble_step,
        lowrank_kriging,
    )
    from glomargridding_tpu_torch.models import lowrank
    from glomargridding_tpu_torch.models.kernel_kriging import _loo_from_K
    from glomargridding_tpu_torch.models.kriging import (
        _ordinary_core,
        _simple_core,
    )

    idx, y, err = obs
    e = torch.diagonal(err).contiguous()
    n, m = psd.n, idx.numel()
    torch.cuda.reset_peak_memory_stats()
    res = lowrank_kriging(psd, idx, y, e)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res_e, members = lowrank_ensemble_step(psd, idx, y, e, gen, N_MEMBERS)
    cv = lowrank_crossval(psd, idx, y, e)
    sync()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_lowrank_outputs(res, members, n, dev)
    sd_scale = float(torch.sqrt(psd.diagonal().max()))
    errs = {}

    def hold(label, got, want):
        for k, v in kriging_errs(got, want, sd_scale).items():
            errs[f"{label}_{k}"] = v

    hold("ensemble_result_vs_kriging", res_e, res)
    del members, res_e
    # the same call on the factors cast to f64
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    hold("f32_vs_f64", res, lowrank_kriging(psd64, idx, y, e))
    # the diagonal-E (Woodbury) route against the dense-E route: a
    # diagonal matrix is recognised and takes the Woodbury route too, so
    # the dense-E route is asked for by its flag
    dense_e = lowrank._result(*lowrank._lowrank_solve(
        psd.vectors, psd.gains, psd.floor, err, idx, y, 0, e_diag=False)[:3])
    hold("woodbury_vs_dense_e", res, dense_e)
    del dense_e
    # cross-validation against the LOO identity in f64 on K off the
    # f64 factors
    V_o = psd64.vectors[idx]
    K64 = (V_o * psd64.gains[None, :]) @ V_o.T + torch.diag(
        psd64.floor[idx] + e.double())
    cv64 = _loo_from_K(K64, y.double(), 0.0, "ordinary")
    for name, got, want in zip(cv._fields, cv, cv64):
        errs[f"crossval_{name}"] = max_rel(got, want)
    del psd64, V_o, K64, cv64

    # the dense classes on the densified covariance
    C = psd.to_dense()
    COUNTS["kriging.solve.cholesky"] = COUNTS["kriging.solve.lu"] = 0
    ok = OrdinaryKriging(C, idx, y, err)
    dense = (ok.solve(), ok.get_uncertainty(), ok.constraint_mask())
    branches = solve_branches()
    if branches["cholesky"] == 0 or branches["lu"] != 0:
        raise AssertionError(f"the repaired K is not positive definite: "
                             f"{branches}")
    hold("factored_vs_dense_class", res, dense)
    # both against f64 solves on the dense matrix's own blocks, and the
    # faults of DENSE_FAULTS read the same way
    Cc = C[idx, :].double()
    C_diag = torch.diagonal(C).double()
    del C, ok
    err64, y64 = err.double(), y.double()
    K = Cc[:, idx] + err64
    eig = torch.linalg.eigvalsh(K)
    oracle = core_outputs(_ordinary_core(K, Cc, C_diag, y64))
    hold("factored_vs_f64_dense", res, oracle)
    hold("dense_class_vs_f64_dense", dense, oracle)
    wrong = {
        "simple_for_ordinary": core_outputs(
            _simple_core(K, Cc, C_diag, y64, 0.0)),
        "error_cov_x1.1": core_outputs(_ordinary_core(
            Cc[:, idx] + 1.1 * err64, Cc, C_diag, y64)),
    }
    faults = {name: max(kriging_errs(got, oracle, sd_scale).values())
              for name, got in wrong.items()}
    del Cc, K, oracle, wrong, dense

    triple = lowrank_consistency(psd, idx, e, gen)
    walls = {
        "lowrank_kriging_s": wall_median_s(
            lambda: lowrank_kriging(psd, idx, y, e)),
        "lowrank_ensemble_step_s": wall_median_s(
            lambda: lowrank_ensemble_step(psd, idx, y, e, gen, N_MEMBERS)),
        "lowrank_crossval_s": wall_median_s(
            lambda: lowrank_crossval(psd, idx, y, e)),
    }
    phase(14, "lowrank_kriging_64800x5000", rank=psd.rank,
          effective_rank=psd.effective_rank, members=N_MEMBERS,
          solve_branches=f"cholesky:{branches['cholesky']}"
                         f"|lu:{branches['lu']}",
          K_eig_min=f"{eig[0].item():.4g}", K_eig_max=f"{eig[-1].item():.4g}",
          K_cond=f"{(eig[-1] / eig[0]).item():.3g}", tol=KRIGING_TOL,
          **{k: f"{v:.3e}" for k, v in errs.items()},
          **{f"fault_{k}": f"{v:.3e}" for k, v in faults.items()},
          **{f"consistency_{k}": f"{v:.4f}" for k, v in triple.items()},
          consistency_ratio_bound=CONSISTENCY_RATIO, repeats=REPEATS,
          **{k: f"{v:.4f}" for k, v in walls.items()},
          peak_gb=f"{peak_gb:.3f}")
    for k, v in errs.items():
        check(f"lowrank {k}", v, KRIGING_TOL)
    for k in DENSE_FAULTS:
        if not faults[k] > KRIGING_TOL:
            raise AssertionError(f"the bound {KRIGING_TOL} passes the fault "
                                 f"{k} ({faults[k]:.3e})")
    check("consistency: largest over smallest of RMSE, mean uncertainty and "
          "member spread", max(triple.values()) / min(triple.values()),
          CONSISTENCY_RATIO)


def phase15_stochastic_dense(dev, glat, glon, psd, obs):
    """The dense stochastic path on the densified repaired covariance
    against the factored members on the same draws, and the eigen-repair
    rescue on an unrepaired (indefinite) matrix."""
    from glomargridding_tpu_torch import (
        StochasticKriging,
        batched_ensemble_step,
        lowrank_members_from_states,
        mv_normal_draw,
    )
    from glomargridding_tpu_torch.models import stochastic
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    idx, y, err = obs
    n, m = psd.n, idx.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    z_state = torch.randn((N_MEMBERS, n), generator=gen, device=dev)
    z_obs = torch.randn((N_MEMBERS, m), generator=gen, device=dev)
    C = psd.to_dense()

    def dense_members():
        return batched_ensemble_step(C, err, idx, y, N_MEMBERS,
                                     noise=(z_state, z_obs))

    torch.cuda.reset_peak_memory_stats()
    members, field = dense_members()
    sync()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if members.shape != (N_MEMBERS, n) or (
            members.device.type != dev.type) or not bool(
            torch.isfinite(members).all()):
        raise AssertionError("dense members malformed")
    # the same states and observation noise through the factors
    L, info = stochastic.draw_factor(C)
    if int(info) != 0:
        raise AssertionError("the repaired covariance has no Cholesky factor")
    states = z_state @ L.T
    del L
    eps = z_obs * torch.sqrt(torch.diagonal(err))[None, :]
    want = lowrank_members_from_states(psd, idx, y, err, states, eps)
    errs = {"dense_vs_factored_members": max_rel(members, want)}
    del want, states, eps
    # one member through the class, on the first member's normals
    sk = StochasticKriging(C, idx, y, err)
    member = sk.solve(noise=(z_state[0], z_obs[0]))
    errs["class_member_vs_batched"] = max_rel(
        member, members[0], torch.max(torch.abs(members)).item())
    errs["class_field_vs_batched"] = max_rel(sk.gridded_field, field)
    del sk, member, members
    wall = wall_median_s(dense_members)
    del C, z_state, z_obs

    # the rescue: the unrepaired nu = 1.5 matrix of N_SYM cells of the
    # grid has no Cholesky factor. The cells include the observed ones,
    # whose block phase 9 found indefinite, so this matrix is too
    # (its smallest eigenvalue is no larger than a principal block's).
    rng = np.random.default_rng(SEED)
    rest = np.setdiff1d(np.arange(n), idx.cpu().numpy())
    cells = np.sort(np.concatenate(
        [idx.cpu().numpy(), rng.choice(rest, N_SYM - m, replace=False)]))
    P = te.pack_points(*ellipse_args(
        glat[cells], glon[cells],
        [f[cells] for f in realistic_ellipse_params(glat, glon)],
        torch.float32, dev))
    C16 = te.ellipse_sym(P, NU_NS)
    if int(stochastic.draw_factor(C16)[1]) == 0:
        raise AssertionError("draw_factor did not report the indefinite "
                             "matrix")
    repairs = Stopwatch(stochastic.eigen_repaired_factor)
    stochastic.eigen_repaired_factor = repairs
    try:
        draws = mv_normal_draw(torch.zeros(N_SYM, device=dev), C16, 4,
                               generator=gen)
    finally:
        stochastic.eigen_repaired_factor = repairs.fn
    if repairs.calls != 1 or draws.shape != (4, N_SYM) or not bool(
            torch.isfinite(draws).all()):
        raise AssertionError(f"rescue: {repairs.calls} repairs, draws "
                             f"{tuple(draws.shape)}")
    phase(15, "stochastic_dense_64800", members=N_MEMBERS,
          covariance_gb=f"{n * n * 4 / 1e9:.1f}", tol=MEMBERS_TOL,
          **{k: f"{v:.3e}" for k, v in errs.items()},
          rescue_size=N_SYM, rescue_ran=repairs.calls,
          rescue_eigh_s=f"{repairs.seconds:.3f}",
          rescue_draw_std=f"{draws.std().item():.4f}", repeats=REPEATS,
          batched_ensemble_step_s=f"{wall:.4f}", peak_gb=f"{peak_gb:.3f}")
    for k, v in errs.items():
        check(f"stochastic {k}", v, MEMBERS_TOL)


def repaired_pipeline(dev, glat, glon, obs):
    """Phases 13-15; returns the padded factors and the K2 launches of
    the repair's store."""
    psd, k2_launches = phase13_psd_repair(dev, glat, glon)
    psd = psd.pad_rank(PAD_RANK)
    phase14_lowrank_kriging(dev, psd, obs)
    phase15_stochastic_dense(dev, glat, glon, psd, obs)
    return psd, k2_launches


def device_busy_s(fn):
    """(busy, wall) of one call of `fn` under ``torch.profiler``: the
    seconds the device spent in kernels, summed over every kernel (None
    where the profiler saw no device activity), and the host's seconds
    around that same call (the profiler's own cost on the host is in it,
    so 1 - busy / wall is the most the device can have idled)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    # the kernels' own rows only: an operator's row repeats the time of
    # the kernels it launched
    total_us = sum(
        getattr(e, "self_device_time_total", None)
        or getattr(e, "self_cuda_time_total", 0)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    return (total_us / 1e6 if total_us > 0 else None), wall


def spread(values):
    """median|99th percentile|max of an array, for a phase line."""
    v = np.asarray(values, dtype=float)
    if v.size == 0:
        return "none"
    return "|".join(f"{q:.3e}" for q in (
        np.median(v), np.percentile(v, 99), v.max()))


def subset_fitter(builder, model, lane, tol, slots=None, fit_kw=None):
    """``EllipseBuilder._chunk_fitter`` (``fit_cells`` and
    ``compute_params`` call it too) with the fit's configuration
    (`fit_kw`, default phase 16's FIT_KW), for fitting chosen lanes: its
    ``fit`` (the optima, the objective there, the iterations, the
    convergence and the lanes with data) and ``build``, the
    start point, the box and the bounds the QC codes are read against.
    With device `slots`, ``fit`` splits each chunk's lanes over them as
    ``compute_params(mesh=...)`` does (``EllipseBuilder._slot_fitter``)."""
    fit_kw = FIT_KW if fit_kw is None else fit_kw
    x0, box, bounds_out = model._fit_setup(
        fit_kw["guesses"], fit_kw["bounds"], builder._x_centered.dtype,
        builder.device)
    geometry = dict(
        min_distance=0.3, max_distance=fit_kw["max_distance"],
        anisotropic=model.anisotropic, delta_x_method="Modified_Met_Office",
        physical_distance=model.physical_distance,
        physical_distance_selection=True,
        max_train_cols=fit_kw["max_train_cols"])
    args = (model, lane, tol, geometry, x0, box)
    fit, build = builder._chunk_fitter(*args)
    if slots is not None:
        fit = builder._slot_fitter(slots, *args)[0]
    return dict(fit=fit, build=build, x0=x0, box=box, bounds_out=bounds_out,
                model=model)


def fit_lanes(fitter, chunks):
    """The chunks of lanes through `fitter`: the raw optima (tensors, one
    per chunk), and, as numpy over all lanes, the canonical parameters
    (n, 3), the QC codes and the iteration counts."""
    from glomargridding_tpu_torch.models.ellipse import estimate

    raw, nit, success = [], [], []
    for sel in chunks:
        x, _, n_it, ok, has_data = fitter["fit"](sel)
        if not bool(has_data.all()):
            raise AssertionError("a subset lane has no training data")
        raw.append(x)
        nit.append(n_it.cpu().numpy())
        success.append(ok.cpu().numpy())
    fitted = np.concatenate([x.cpu().numpy() for x in raw])
    pm, qc, _ = estimate._postprocess_fits(
        fitted, np.concatenate(success), fitter["model"],
        fitter["bounds_out"], 3)
    return raw, pm, qc, np.concatenate(nit)


def fit_deviation(a, b, keep):
    """Canonical (Lx, Ly, theta) rows `a` against `b` on the lanes of
    `keep`: |dLx| / Lx, |dLy| / Ly, and |dtheta| modulo pi."""
    a, b = a[keep], b[keep]
    dth = np.abs(a[:, 2] - b[:, 2]) % np.pi
    return {"Lx_rel": np.abs(a[:, 0] - b[:, 0]) / b[:, 0],
            "Ly_rel": np.abs(a[:, 1] - b[:, 1]) / b[:, 1],
            "theta_abs": np.minimum(dth, np.pi - dth)}


def share_within(deviation, names):
    """The share of lanes whose deviations `names` all hold their bound
    (FIT_REL_TOL for a length, FIT_THETA_TOL for the angle)."""
    ok = np.ones(deviation[names[0]].shape, dtype=bool)
    for name in names:
        ok &= deviation[name] <= (
            FIT_THETA_TOL if name == "theta_abs" else FIT_REL_TOL)
    return float(ok.mean())


def summed_in_f32_fit(fitter, sel):
    """One chunk fitted by Nelder-Mead on the reference's form of the
    unit-sigma objective, ``-sum(norm.logpdf(z_y, z_model, 1) * w)``
    with every term and the sum in the data's dtype; returns what a
    chunk fitter's ``fit`` returns."""
    from glomargridding_tpu_torch.ops import optim

    model = fitter["model"]
    log_sqrt_2pi = 0.5 * np.log(2.0 * np.pi)

    def nll(params, X, z_y, weights):
        z_model, _ = model._masked_model_z(params, X, weights)
        r = z_y - z_model
        return -torch.sum((-0.5 * r * r - log_sqrt_2pi) * weights)

    X, z_y, w = fitter["build"](sel)
    x0 = fitter["x0"][None, :].expand(len(sel), fitter["x0"].shape[0])
    res = optim.batched_nelder_mead(nll, x0, (X, z_y, w), fitter["box"],
                                    xatol=FIT_KW["tol"], fatol=FIT_KW["tol"])
    return res.x, res.fun, res.nit, res.success, torch.sum(w, dim=1) > 0


def gather_times(builder, sel):
    """The top-k column gather of one chunk, as the port does it (X, y
    and w one by one) against one gather of the three packed (B, N, 4):
    (ms, ms)."""
    from glomargridding_tpu_torch.models.ellipse import estimate

    lats, lons = builder._point_coords()
    sel_t = torch.as_tensor(sel, device=builder.device)
    X, w = estimate._train_geometry_arrays(
        lats, lons, sel_t, min_distance=0.3,
        max_distance=FIT_KW["max_distance"], anisotropic=True,
        delta_x_method="Modified_Met_Office", physical_distance=True,
        physical_distance_selection=True)
    y = builder.cor[sel_t, :]
    k = FIT_KW["max_train_cols"]

    def packed():
        d2 = torch.where(w > 0, X[..., 0] ** 2 + X[..., 1] ** 2, torch.inf)
        cols = torch.topk(d2, k, dim=1, largest=False).indices
        del d2
        P = torch.cat([X, y[..., None], w[..., None]], dim=-1)
        return torch.take_along_dim(P, cols[..., None], dim=1)

    thrice_ms = cuda_time_ms(
        lambda: estimate._nearest_train_cols(X, y, w, k, True), iters=3)
    return thrice_ms, cuda_time_ms(packed, iters=3)


def polar_lanes(builder64, model, qc_f32):
    """One chunk of polar lanes (81 to 87 N), where the f32 simplex
    ends most lanes with Ly on its lower bound (QC 1): the simplex and
    Levenberg-Marquardt in f64 on those lanes, and the f64 likelihood
    each ends at. Printed, not held: it says whether the bound is where
    the likelihood is least or where the simplex got caught."""
    sel = np.arange(POLAR_START, POLAR_START + FIT_KW["chunk_size"])
    found = {}
    for lane, tol in (("nm", FIT_KW["tol"]), ("lm", LM_TOL)):
        fitter = subset_fitter(builder64, model, lane, tol)
        found[lane] = fit_lanes(fitter, [sel])
    data = subset_fitter(builder64, model, "nm", FIT_KW["tol"])["build"](sel)
    nll = torch.func.vmap(model._nll_fit_z)
    with torch.no_grad():
        at = {lane: nll(found[lane][0][0], *data).cpu().numpy()
              for lane in found}
    gain = at["nm"] - at["lm"]  # > 0: LM ends at the lower likelihood
    (_, pm_nm, qc_nm, _), (_, pm_lm, qc_lm, _) = found["nm"], found["lm"]
    caught = (qc_nm == 1) & (qc_lm == 0)
    lo = FIT_KW["bounds"][1][0]

    def counts(qc):
        codes, n = np.unique(qc, return_counts=True)
        return "|".join(f"{c}:{k}" for c, k in zip(codes, n))

    phase(16, "ellipse_mle_polar", lanes=sel.size,
          qc_nm_f32=counts(qc_f32[sel]), qc_nm_f64=counts(qc_nm),
          qc_lm_f64=counts(qc_lm), nm_qc1_lm_qc0=int(caught.sum()),
          nm_f64_Ly_at_bound=int(np.sum(pm_nm[:, 1] <= lo * 1.001)),
          lm_lower_by_more_than_tol=(
              int(np.sum(gain[caught] > FIT_KW["tol"])) if caught.any()
              else 0),
          nm_lower_by_more_than_tol=(
              int(np.sum(-gain[caught] > FIT_KW["tol"])) if caught.any()
              else 0),
          nll_nm_minus_lm=spread(gain[caught]) if caught.any() else "none",
          lm_Ly_median=(f"{np.median(pm_lm[caught, 1]):.1f}"
                        if caught.any() else "none"),
          nm_Lx_median=(f"{np.median(pm_nm[caught, 0]):.1f}"
                        if caught.any() else "none"),
          lm_Lx_median=(f"{np.median(pm_lm[caught, 0]):.1f}"
                        if caught.any() else "none"))


def check_canonical(flat):
    """Fitted fields in the canonical form of ``estimate.
    _postprocess_fits``, or an AssertionError: Lx >= Ly, and the angle
    shifted once by pi into [-pi, 3 pi / 2] (a raw angle in the box
    [-2 pi, 2 pi], a quarter turn added where the axes swapped; the ends
    to an f32 rounding of the box)."""
    theta = flat["theta"]
    swapped = int((flat["Ly"] > flat["Lx"]).sum())
    ends = (-np.pi - 1e-6, 1.5 * np.pi + 1e-6)
    if swapped or not ((theta >= ends[0]) & (theta <= ends[1])).all():
        raise AssertionError(
            f"the fitted fields are not canonical: Ly > Lx on {swapped} "
            f"lanes, theta in [{theta.min():.4f}, {theta.max():.4f}]")


def phase16_whole_grid_fit(dev, glat, glon, psd):
    """The ellipse MLE on every cell of the 1-degree grid by
    Levenberg-Marquardt, from a cube drawn from the repaired covariance,
    and the simplex on the subset's lanes (the simplex's whole-grid fit,
    and its lanes against it bit for bit, are phase 29's at 259,200
    cells).
    - f32 against the f64 run of the same code (the lazy correlation,
      f64 coordinates), on lanes with QC 0 in both: the share of lanes
      within FIT_REL_TOL on Lx and Ly, the share within those and
      FIT_THETA_TOL on the angle (see there), and the share of equal QC
      codes.
    - Levenberg-Marquardt (tol 1e-8, in f64 and in f32) against
      Nelder-Mead in f64, on lanes with QC 0 in both: the share within
      FIT_REL_TOL and FIT_THETA_TOL,
      and no lane fails that Nelder-Mead fitted.
    - The whole grid by Levenberg-Marquardt in f32: its wall, its QC
      codes, and its subset lanes in the comparison above.
    - The reference's summation of the likelihood (all in f32) must
      leave fewer lanes within FIT_REL_TOL than the port's f64 sum, and
      fewer within all three bounds than FIT_SHARE_NM_F32_ELLIPSE.
    - One chunk of polar lanes, where the f32 simplex ends with Ly on
      its lower bound: the simplex and Levenberg-Marquardt in f64, and
      the f64 likelihood at both optima (printed, not held).
    - The negative control: the same f32 fit at nu = 0.5 against the f64
      fit at nu = 1.5 must leave at most FIT_WRONG_SHARE of lanes within
      FIT_REL_TOL.
    """
    from glomargridding_tpu_torch import (
        Coordinates,
        EllipseBuilder,
        EllipseModel,
    )
    from glomargridding_tpu_torch.models.ellipse import estimate
    from glomargridding_tpu_torch.ops import optim

    lat_axis, lon_axis = np.unique(glat), np.unique(glon)
    shape = (lat_axis.size, lon_axis.size)
    n = glat.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cube = psd.draw(T_TRAIN, generator=gen).contiguous().reshape(
        T_TRAIN, *shape)

    def coords(dtype):
        return Coordinates({"time": np.arange(T_TRAIN),
                            "latitude": lat_axis.astype(dtype),
                            "longitude": lon_axis.astype(dtype)})

    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    # no device named: the cube's
    builder = EllipseBuilder(cube, coords(np.float32))
    sync()
    out = {"builder_s": time.perf_counter() - t0}
    cor = builder.cor
    if not isinstance(cor, torch.Tensor) or cor.device.type != dev.type or (
            cor.shape != (n, n) or cor.dtype != torch.float32):
        raise AssertionError("the correlation is not dense f32 on the card")
    del cor
    out["calc_cov_s"] = wall_median_s(builder.calc_cov)

    model, params, fitted_lm, qc_lm32 = phase16_lm_fit(builder, out, glat,
                                                       glon)
    chunks = [np.arange(s, s + FIT_KW["chunk_size"]) for s in SUBSET_STARTS]
    f32 = phase16_window(builder, model, chunks)
    subset = phase16_subset(builder, model, cube, coords, chunks, f32,
                            fitted_lm, qc_lm32)
    return params, builder, (lat_axis, lon_axis), subset


def phase16_lm_fit(builder, out, glat, glon):
    """Phase 16's whole-grid fit by Levenberg-Marquardt, its chunks
    counted and timed: (model, params, fitted (n, 3), QC codes)."""
    from glomargridding_tpu_torch import EllipseModel
    from glomargridding_tpu_torch.models.ellipse import estimate

    n = glat.size
    # the whole grid by Levenberg-Marquardt (the simplex's whole-grid
    # fit, and its chunks against the whole grid bit for bit, are phase
    # 29's at 259,200 cells; here the simplex fits the held lanes)
    model = EllipseModel(**FIT_MODEL)
    watch = {"build": Stopwatch(estimate._chunk_train_data),
             "solve": Stopwatch(estimate.batched_levenberg_marquardt)}
    iterations = []

    def solve(*args, **kwargs):
        res = watch["solve"](*args, **kwargs)
        iterations.append(int(res.nit.max()))
        return res

    keep = estimate._chunk_train_data, estimate.batched_levenberg_marquardt
    estimate._chunk_train_data, estimate.batched_levenberg_marquardt = (
        watch["build"], solve)
    try:
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        params = builder.compute_params(FIT_DEFAULTS, model,
                                        **{**FIT_KW, "tol": LM_TOL},
                                        opt_method="lm")
        sync()
        out["fit_s"] = time.perf_counter() - t0
    finally:
        (estimate._chunk_train_data,
         estimate.batched_levenberg_marquardt) = keep
    out["fit_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def fields(dataset):
        flat = {k: np.asarray(dataset[k].values, dtype=float).reshape(-1)
                for k in dataset.keys()}
        for name, values in flat.items():
            if values.shape != (n,) or not np.isfinite(values).all():
                raise AssertionError(f"fitted field {name} malformed")
        return flat, np.column_stack(
            [flat["Lx"], flat["Ly"], flat["theta"]]), flat["qc_code"].astype(
                int)

    flat_lm, fitted_lm, qc_lm32 = fields(params)
    nit = flat_lm["number_of_iterations"]
    lo, hi = FIT_KW["bounds"][0]
    for name in ("Lx", "Ly"):
        if flat_lm[name].min() < lo or flat_lm[name].max() > hi:
            raise AssertionError(f"{name} left its box")
    check_canonical(flat_lm)
    chunk = FIT_KW["chunk_size"]
    n_chunks = -(-n // chunk)
    if watch["solve"].calls != n_chunks or watch["build"].calls != n_chunks:
        raise AssertionError(
            f"{watch['solve'].calls} solves for {n_chunks} chunks")
    # recovery of the fields the cube was drawn from (printed, not held:
    # the clip and its floor change the local correlation)
    tLx, tLy, tth, _ = (f.astype(float) for f in realistic_ellipse_params(
        glat, glon))
    swap = tLy > tLx
    truth = np.column_stack([np.where(swap, tLy, tLx),
                             np.where(swap, tLx, tLy),
                             tth + swap * np.pi / 2])
    good = qc_lm32 == 0
    recovery = fit_deviation(fitted_lm, truth, good)
    build_s = [dt for _, dt in watch["build"].log]
    solve_s = [dt for _, dt in watch["solve"].log]
    codes, counts = np.unique(qc_lm32, return_counts=True)
    phase(16, "ellipse_mle_64800_lm", T=T_TRAIN, nu=NU_NS, lanes=n,
          chunks=n_chunks, cols=FIT_KW["max_train_cols"], tol=LM_TOL,
          cor_gb=f"{n * n * 4 / 1e9:.1f}",
          builder_s=f"{out['builder_s']:.4f}",
          calc_cov_s=f"{out['calc_cov_s']:.4f}",
          fit_s=f"{out['fit_s']:.3f}",
          chunk_build_s=f"{sum(build_s):.3f}",
          chunk_solve_s=f"{sum(solve_s):.3f}",
          chunk_solve_s_min_max=f"{min(solve_s):.3f}|{max(solve_s):.3f}",
          loop_iterations=sum(iterations),
          ms_per_iteration=f"{1e3 * sum(solve_s) / sum(iterations):.3f}",
          nit_median=f"{np.median(nit):.0f}", nit_max=f"{nit.max():.0f}",
          qc_counts="|".join(f"{c}:{k}" for c, k in zip(codes, counts)),
          fit_peak_gb=f"{out['fit_peak_gb']:.3f}",
          recovery_Lx_ratio_median=(
              f"{np.median(fitted_lm[good, 0] / truth[good, 0]):.4f}"),
          recovery_Ly_ratio_median=(
              f"{np.median(fitted_lm[good, 1] / truth[good, 1]):.4f}"),
          recovery_theta_abs_median=(
              f"{np.median(recovery['theta_abs']):.4f}"))

    return model, params, fitted_lm, qc_lm32


def phase16_window(builder, model, chunks):
    """One chunk's build and a window of its solve: memory per pair, the
    two gathers and the device's idle share; returns the f32 simplex's
    chunk fitter."""
    from glomargridding_tpu_torch.ops import optim

    n, chunk = builder.small_covar_size, FIT_KW["chunk_size"]
    f32 = subset_fitter(builder, model, "nm", FIT_KW["tol"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    data = f32["build"](chunks[0])
    sync()
    per_pair = (torch.cuda.max_memory_allocated() - base) / (chunk * n * 4)
    thrice_ms, packed_ms = gather_times(builder, chunks[0])
    x0 = f32["x0"][None, :].expand(chunk, 3)

    def window():
        return optim.batched_nelder_mead(
            model._nll_fit_z, x0, data, f32["box"], xatol=FIT_KW["tol"],
            fatol=FIT_KW["tol"], maxiter=PROFILE_ITERS)

    wall_1 = wall_median_s(window)
    busy, wall_profiled = device_busy_s(window)
    del data
    phase(16, "ellipse_mle_window", lanes=chunk, iterations=PROFILE_ITERS,
          build_values_per_pair=f"{per_pair:.2f}",
          gather_thrice_ms=f"{thrice_ms:.3f}",
          gather_packed_ms=f"{packed_ms:.3f}",
          window_s=f"{wall_1:.4f}",
          device_busy_s="not measured" if busy is None else f"{busy:.4f}",
          profiled_call_s=f"{wall_profiled:.4f}",
          # inside the profiled call (the profiler's host cost counts as
          # idle), and the same kernels against the wall of the
          # unprofiled calls, which are other calls
          device_idle_share_profiled_call="not measured" if busy is None
          else f"{1.0 - busy / wall_profiled:.4f}",
          device_idle_share_vs_unprofiled_wall="not measured"
          if busy is None else f"{1.0 - busy / wall_1:.4f}")

    return f32


def phase16_subset(builder, model, cube, coords, chunks, f32, fitted_lm,
                   qc_lm32):
    """The subset's lanes through the chunk fitter: the f32 simplex
    against f64, LM, the f32-summed likelihood, the wrong order and the
    polar chunk (see ``phase16_whole_grid_fit``)."""
    from glomargridding_tpu_torch import EllipseBuilder, EllipseModel

    n = builder.small_covar_size
    chunk = FIT_KW["chunk_size"]
    # the subset: the same lanes through the chunk fitter
    lanes = np.concatenate(chunks)
    # every simplex below runs on K5 but the f32-summed one
    COUNTS["k5.launches"] = 0
    raw32, pm32, qc32, _ = fit_lanes(f32, chunks)
    polar = np.arange(POLAR_START, POLAR_START + chunk)
    qc_polar = np.full(n, -1)
    qc_polar[polar] = fit_lanes(f32, [polar])[2]
    builder64 = EllipseBuilder(cube.double(), coords(np.float64),
                               cor_mode="lazy")

    def timed_fit(builder, model, lane, tol):
        sync()
        t0 = time.perf_counter()
        fitter = subset_fitter(builder, model, lane, tol)
        found = fit_lanes(fitter, chunks)
        sync()
        return fitter, found, time.perf_counter() - t0

    f64, (raw64, pm64, qc64, nit64), f64_s = timed_fit(
        builder64, model, "nm", FIT_KW["tol"])
    _, (_, pm_lm, qc_lm, nit_lm), lm_s = timed_fit(
        builder64, model, "lm", LM_TOL)
    pm_lm32, qc_lm32 = fitted_lm[lanes], qc_lm32[lanes]
    # the reference's summation, every term and the sum in f32: what the
    # f64 sum of ``model._weighted_nll`` is there for
    summed = dict(f32, fit=lambda sel: summed_in_f32_fit(f32, sel))
    _, pm_s, qc_s, nit_s = fit_lanes(summed, chunks)
    # the negative control: the f32 fit at the wrong order
    _, (_, pm_w, qc_w, _), _ = timed_fit(
        builder, EllipseModel(**{**FIT_MODEL, "v": 0.5}), "nm",
        FIT_KW["tol"])
    polar_lanes(builder64, model, qc_polar)
    k5 = require_launches("K5 (phase 16's simplex)", COUNTS["k5.launches"])
    del builder64
    both = (qc32 == 0) & (qc64 == 0)
    lengths = ("Lx_rel", "Ly_rel")
    ellipse = (*lengths, "theta_abs")
    devs = {"nm_f32_vs_f64": fit_deviation(pm32, pm64, both),
            "lm_vs_nm_f64": fit_deviation(
                pm_lm, pm64, (qc_lm == 0) & (qc64 == 0)),
            "lm_f32_vs_nm_f64": fit_deviation(
                pm_lm32, pm64, (qc_lm32 == 0) & (qc64 == 0)),
            "summed_f32_vs_f64": fit_deviation(
                pm_s, pm64, (qc_s == 0) & (qc64 == 0)),
            "wrong_nu": fit_deviation(pm_w, pm64, (qc_w == 0) & (qc64 == 0))}
    shares = {
        "nm_f32_vs_f64_lengths": share_within(devs["nm_f32_vs_f64"], lengths),
        "nm_f32_vs_f64_ellipse": share_within(devs["nm_f32_vs_f64"], ellipse),
        "lm_vs_nm_f64_ellipse": share_within(devs["lm_vs_nm_f64"], ellipse),
        "lm_f32_vs_nm_f64_ellipse": share_within(devs["lm_f32_vs_nm_f64"],
                                                 ellipse),
        "summed_f32_vs_f64_lengths": share_within(devs["summed_f32_vs_f64"],
                                                  lengths),
        "summed_f32_vs_f64_ellipse": share_within(devs["summed_f32_vs_f64"],
                                                  ellipse),
        "wrong_nu_lengths": share_within(devs["wrong_nu"], lengths),
    }
    qc_share = float(np.mean(qc32 == qc64))
    failed = {"lm_f64": int(np.sum((qc_lm == 9) & (qc64 != 9))),
              "lm_f32": int(np.sum((qc_lm32 == 9) & (qc64 != 9)))}
    phase(16, "ellipse_mle_subset", lanes=lanes.size,
          qc0_in_both=int(both.sum()), k5_launches=k5,
          simplex_qc1_lm_qc0=int(np.sum((qc32 == 1) & (qc_lm32 == 0))),
          nm_f64_s=f"{f64_s:.3f}", nm_f64_nit_median=f"{np.median(nit64):.0f}",
          lm_f64_s=f"{lm_s:.3f}", lm_f64_nit_median=f"{np.median(nit_lm):.0f}",
          summed_f32_nit_median=f"{np.median(nit_s):.0f}",
          summed_f32_theta_abs_median=(
              f"{np.median(np.abs(pm_s[qc_s == 0, 2])):.4f}"),
          **{f"{k}_{name}": spread(v) for k, d in devs.items()
             for name, v in d.items()},
          nm_f32_theta_abs_median=f"{np.median(np.abs(pm32[both, 2])):.4f}",
          nm_f64_theta_abs_median=f"{np.median(np.abs(pm64[both, 2])):.4f}",
          rel_tol=FIT_REL_TOL, theta_tol=FIT_THETA_TOL,
          **{f"share_{k}": f"{v:.4f}" for k, v in shares.items()},
          share_bound_nm_f32=FIT_SHARE_NM_F32,
          share_bound_nm_f32_ellipse=FIT_SHARE_NM_F32_ELLIPSE,
          share_bound_lm=FIT_SHARE_LM,
          wrong_nu_share_bound=FIT_WRONG_SHARE,
          qc_equal_share=f"{qc_share:.4f}", qc_share_bound=FIT_QC_SHARE,
          **{f"{k}_failed_where_nm_fitted": v for k, v in failed.items()})
    for name, least in (("nm_f32_vs_f64_lengths", FIT_SHARE_NM_F32),
                        ("nm_f32_vs_f64_ellipse", FIT_SHARE_NM_F32_ELLIPSE),
                        ("lm_vs_nm_f64_ellipse", FIT_SHARE_LM),
                        ("lm_f32_vs_nm_f64_ellipse", FIT_SHARE_LM)):
        if not shares[name] >= least:
            raise AssertionError(
                f"{name}: {shares[name]:.4f} of lanes within the bounds, "
                f"under {least}")
    if not (shares["summed_f32_vs_f64_lengths"]
            < shares["nm_f32_vs_f64_lengths"]):
        raise AssertionError(
            "the likelihood summed in f32 fits as many lanes as the one "
            "summed in f64: "
            f"{shares['summed_f32_vs_f64_lengths']:.4f}")
    if not shares["summed_f32_vs_f64_ellipse"] < FIT_SHARE_NM_F32_ELLIPSE:
        raise AssertionError(
            f"the bound {FIT_SHARE_NM_F32_ELLIPSE} passes the likelihood "
            "summed in f32: "
            f"{shares['summed_f32_vs_f64_ellipse']:.4f}")
    if not shares["wrong_nu_lengths"] <= FIT_WRONG_SHARE:
        raise AssertionError(
            f"the bound {FIT_REL_TOL} passes the fit at nu = 0.5 on "
            f"{shares['wrong_nu_lengths']:.4f} of lanes")
    if not qc_share >= FIT_QC_SHARE:
        raise AssertionError(f"QC codes agree on {qc_share:.4f} of lanes")
    if any(failed.values()):
        raise AssertionError(f"LM failed lanes that NM fitted: {failed}")
    return dict(chunks=chunks, f32=f32, f64=f64, raw32=raw32, raw64=raw64,
                pm32=pm32, pm64=pm64, both=both, k5_launches=k5)


def phase17_fitted_covariance(dev, params, axes):
    """The fitted fields through ``convert.ellipse_builder_from_dataset``
    into K2, and the matrix against K4 in f64 on a row band (off the
    pairs 180 degrees apart, as in phase 9). Returns the K2 launches."""
    from glomargridding_tpu_torch import convert
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    lat_axis, lon_axis = axes
    reset_ellipse_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    # no device named: the card
    cb = convert.ellipse_builder_from_dataset(params, lat_axis, lon_axis,
                                              v=NU_NS)
    cov = cb.cov_ns
    sync()
    seconds = time.perf_counter() - t0
    k2_launches = require_launches("K2 (fitted fields)",
                                   COUNTS["k2.launches"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = cb.covar_size
    if cov.device.type != dev.type or cov.shape != (m, m) or (
            cov.dtype != torch.float32):
        raise AssertionError(f"covariance {tuple(cov.shape)} {cov.dtype}")
    rows = slice(min(BAND_ROWS.start, m // 2),
                 min(BAND_ROWS.stop, m))
    got = cov[rows].double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite covariance of the fitted fields")
    diag_rel = max_rel(torch.diagonal(cov),
                       torch.as_tensor(cb.stdev_compressed, device=dev) ** 2)
    del cov
    P = te.pack_points(*ellipse_args(
        cb.lat_grid_compressed, cb.lon_grid_compressed,
        [cb.Lx_compressed, cb.Ly_compressed, cb.theta_compressed,
         cb.stdev_compressed], torch.float64, dev))
    want = te.ellipse_tile(P[rows], P, NU_NS)
    band = torch.arange(rows.start, rows.stop, device=dev)
    want[torch.arange(band.numel(), device=dev), band] += P[band, 6] ** 2
    lon = torch.as_tensor(cb.lon_grid_compressed, device=dev).double()
    antimeridian = torch.abs(lon[band][:, None] - lon[None, :]) == 180.0
    dev_rel = torch.abs(got - want) / torch.max(torch.abs(want)).item()
    err = torch.max(dev_rel[~antimeridian]).item()
    phase(17, "fitted_fields_through_k2", points=m,
          masked=int(np.prod(cb.xy_shape)) - m, k2_launches=k2_launches,
          build_s=f"{seconds:.4f}", peak_gb=f"{peak_gb:.3f}",
          band=f"{rows.stop - rows.start}x{m}",
          covariance_vs_k4_f64=f"{err:.3e}",
          covariance_antimeridian=(
              f"{torch.max(dev_rel[antimeridian]).item():.3e}"),
          covariance_tol=COVARIANCE_TOL, diagonal_vs_stdev2=f"{diag_rel:.3e}")
    check("fitted covariance f32 (K2) vs K4 f64 (off the antimeridian)", err,
          COVARIANCE_TOL)
    check("fitted covariance diagonal vs stdev^2", diag_rel,
          ELLIPSE_RTOL[torch.float32])
    return k2_launches


def phase18_hessian_se(subset):
    """Fisher-information standard errors on the subset: f32 against f64
    at the same (f32) optima, the share of finite ones, and the fit's
    f32-f64 deviation in units of the f64 standard error."""
    from glomargridding_tpu_torch.models.ellipse import estimate

    se, seconds = {}, {}
    for tag, points in (("f32", subset["raw32"]), ("f64", subset["raw32"]),
                        ("f64_own", subset["raw64"])):
        fitter = subset[tag[:3]]
        sync()
        t0 = time.perf_counter()
        parts = []
        for sel, x in zip(subset["chunks"], points):
            parts.append(estimate._chunk_hessian_se(
                fitter["model"]._nll_fit_z, fitter["build"](sel),
                x.to(fitter["x0"].dtype)))
        sync()
        seconds[tag] = time.perf_counter() - t0
        se[tag] = torch.cat(parts).double().cpu().numpy()
    good = subset["both"]
    finite = np.isfinite(se["f32"][good]).all(axis=1)
    share = float(finite.mean())
    share_own = float(np.isfinite(se["f64_own"][good]).all(axis=1).mean())
    ok = good.copy()
    ok[good] = finite & np.isfinite(se["f64"][good]).all(axis=1)
    rel = np.abs(se["f32"][ok] - se["f64"][ok]) / se["f64"][ok]
    # the fit's f32-f64 deviation over the f64 standard error at the f64
    # optimum (raw optima: the standard errors belong to the raw axes)
    raw = [np.concatenate([x.double().cpu().numpy() for x in subset[k]])
           for k in ("raw32", "raw64")]
    ok_own = ok & np.isfinite(se["f64_own"]).all(axis=1)
    delta = np.abs(raw[0] - raw[1])[ok_own]
    delta[:, 2] = np.minimum(delta[:, 2] % np.pi,
                             np.pi - delta[:, 2] % np.pi)
    scaled = delta / se["f64_own"][ok_own]
    phase(18, "hessian_se_subset", lanes=int(good.size),
          qc0_in_both=int(good.sum()), f32_s=f"{seconds['f32']:.3f}",
          f64_s=f"{seconds['f64']:.3f}", finite_share=f"{share:.4f}",
          finite_share_at_f64_optima=f"{share_own:.4f}",
          finite_share_bounds=f"{SE_FINITE_SHARE_F32}|{SE_FINITE_SHARE}",
          f32_vs_f64_rel=spread(rel), se_rtol=SE_RTOL,
          se_over_L_median="|".join(
              f"{v:.3e}" for v in np.median(
                  se["f64_own"][ok_own][:, :2] / raw[1][ok_own][:, :2],
                  axis=0)),
          se_theta_median=f"{np.median(se['f64_own'][ok_own][:, 2]):.3e}",
          fit_deviation_over_se=spread(scaled.max(axis=1)))
    check("Hessian SE f32 vs f64", rel.max(), SE_RTOL)
    if not (share >= SE_FINITE_SHARE_F32 and share_own >= SE_FINITE_SHARE):
        raise AssertionError(
            f"finite standard errors on {share:.4f} of the f32 optima and "
            f"{share_own:.4f} of the f64 optima")


def estimation_path(dev, glat, glon, psd):
    """Phases 16-18; returns the K2 launches of the fitted fields and K5's
    of phase 16's simplex."""
    params, builder, axes, subset = phase16_whole_grid_fit(
        dev, glat, glon, psd)
    k2_launches = phase17_fitted_covariance(dev, params, axes)
    phase18_hessian_se(subset)
    k5_launches = subset["k5_launches"]
    del builder, subset
    return k2_launches, k5_launches


def widening_flavours(mv, n, trace, dev):
    """The clip of one operator from k0 = 512 as the port widens, by
    locking the converged Ritz pairs, and with nothing locked
    (``eigsh._converged_prefix`` made to find none, and put back), so
    that every pair re-iterates with the fresh columns: the joint
    widening the reference uses below 200,000 points, up to a rotation
    of the carried block. What each took, as seconds and as a line of
    text."""
    from glomargridding_tpu_torch import explained_variance_clip_lowrank
    from glomargridding_tpu_torch.ops import eigsh

    converged_prefix = eigsh._converged_prefix
    found = {}
    try:
        for flavour, prefix in (("locked", converged_prefix),
                                ("joint", lambda rn, scale, tol: 0)):
            eigsh._converged_prefix = prefix
            sweeps = Stopwatch(mv)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            before = COUNTS.copy()
            sync()
            t0 = time.perf_counter()
            out = explained_variance_clip_lowrank(
                sweeps, n=n, trace=trace,
                target_variance_fraction=CLIP_TARGET, generator=gen,
                **WIDENING_CLIP_KW)
            sync()
            seconds = time.perf_counter() - t0
            counts = solver_counts(before)
            check(f"clip at {n} ({flavour}): trace",
                  abs(out.trace() - trace) / trace, TRACE_TOL)
            if counts["stages"] < 2:
                raise AssertionError(
                    f"the clip at {n} did not widen: the flavours were not "
                    "compared")
            found[flavour] = seconds, (
                f"{seconds:.3f}s,stages:{counts['stages']},"
                f"sweeps:{counts['sweeps']},sweeps_s:{sweeps.seconds:.3f},"
                f"columns:{counts['columns']},"
                f"rank:{out.rank},effective:{out.effective_rank}")
    finally:
        eigsh._converged_prefix = converged_prefix
    return found


def phase19_thresholds(dev, psd):
    """What the port's size thresholds stand on, measured on this card:
    ``_AUTO_PARTIAL_THRESHOLD`` (full against partial clip, K2-built f32
    matrices of bench.py:511-524's fields, best of two),
    ``_DENSIFY_GUARD`` (``to_dense()`` of the 64,800-cell factors) and
    the eigensolver's locked widening (a clip that has to widen, locked
    against joint, at 16,200, 64,800 and 259,200 cells)."""
    from glomargridding_tpu_torch import (
        ellipse_covariance_operator,
        explained_variance_clip,
    )
    from glomargridding_tpu_torch.ops import covariance_tools
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    clip_s = {}
    for n in THRESHOLD_SIZES:
        lats, lons, fields = bench_fields(n)
        C = te.ellipse_sym(te.pack_points(*ellipse_args(
            lats, lons, fields, torch.float32, dev)), NU_NS)
        for spectrum in ("full", "partial"):
            clip_s[n, spectrum] = min(timed(lambda: explained_variance_clip(
                C, CLIP_TARGET, spectrum=spectrum)) for _ in range(2))
        del C
    faster = [n for n in THRESHOLD_SIZES
              if clip_s[n, "partial"] < clip_s[n, "full"]]

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dense = []
    dense_s = timed(lambda: dense.append(psd.to_dense()))
    dense_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    dense.clear()

    # the bf16 store of the 2-degree and of the 1-degree grid (a sweep is
    # one GEMM) and the 259,200-cell stream (a sweep rebuilds every tile)
    widening, won = {}, []
    for label, (lats, lons), store in (
            ("store_16200", grid_linspace(*WIDENING_SMALL_GRID),
             dict(store="bf16")),
            ("store_64800", grid_1deg(), dict(store="bf16")),
            ("stream_259200", grid_linspace(*STREAM_GRID),
             dict(store="stream", max_dist=MAX_DIST_KM))):
        mv, n, trace = ellipse_covariance_operator(
            *ellipse_args(lats, lons, realistic_ellipse_params(lats, lons),
                          torch.float32, dev), v=NU_NS, **store)
        found = widening_flavours(mv, n, trace, dev)
        for flavour, (_, text) in found.items():
            widening[f"clip_{label}_{flavour}"] = text
        if found["locked"][0] < found["joint"][0]:
            won.append(n)
        del mv
    phase(19, "thresholds", clip_target=CLIP_TARGET,
          **{f"clip_{n}_full|partial_s":
             f"{clip_s[n, 'full']:.4f}|{clip_s[n, 'partial']:.4f}"
             for n in THRESHOLD_SIZES},
          partial_faster_from=min(faster) if faster else "none",
          auto_partial_threshold=covariance_tools._AUTO_PARTIAL_THRESHOLD,
          to_dense_64800_s=f"{dense_s:.4f}",
          to_dense_64800_peak_gb=f"{dense_gb:.3f}",
          device_total_gb=f"{total_gb:.1f}",
          densify_guard=covariance_tools._DENSIFY_GUARD,
          **widening, locked_faster_at="|".join(map(str, won)) or "none")


# ---------------------------------------------------------------------------
# phases 20-24: sampling and fitting
# ---------------------------------------------------------------------------
def axes(deg):
    """The (lat, lon) axes of the regular `deg`-degree grid."""
    return (np.arange(-90.0 + deg / 2, 90.0, deg),
            np.arange(-180.0 + deg / 2, 180.0, deg))


def timed_s(fn):
    """(result, seconds) of one call, on the host's clock around device
    synchronisation."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase20_kv_general(dev, glat, glon, obs):
    """The general-order K_nu against scipy on the card, and ordinary
    kriging of the main path at nu = 1.0 through the plain tile."""
    from scipy.special import kv as scipy_kv
    from scipy.special import kvp as scipy_kvp

    from glomargridding_tpu_torch import (
        MaternVariogram,
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        pairwise_covariance,
        tile_route,
    )
    from glomargridding_tpu_torch.ops.special import kv

    x = np.concatenate([np.logspace(-6.0, np.log10(700.0), 4000),
                        [2.0, np.nextafter(2.0, 3.0), np.nextafter(2.0, 1.0)]])
    worst = {}
    for dtype, nu in product((torch.float64, torch.float32), KV_ORDERS):
        xt = torch.tensor(x, dtype=dtype, device=dev, requires_grad=True)
        k = kv(nu, xt)
        (g,) = torch.autograd.grad(k.sum(), xt)
        xs = xt.detach().double().cpu().numpy()  # x as the dtype holds it
        for name, got, want in (("value", k, scipy_kv(nu, xs)),
                                ("grad", g, scipy_kvp(nu, xs))):
            got = got.detach().double().cpu().numpy()
            sel = (np.abs(want) > KV_TAIL[dtype]) & (
                np.abs(want) < 1.0 / KV_TAIL[dtype])
            rel = np.abs(got[sel] - want[sel]) / np.abs(want[sel])
            if not np.isfinite(rel).all():
                raise AssertionError(f"K_nu {dtype} nu={nu}: non-finite "
                                     f"{name}")
            key = (dtype, name)
            worst[key] = max(worst.get(key, 0.0), float(rel.max()))
    for (dtype, name), rel in worst.items():
        check(f"K_nu {name} vs scipy, {dtype}", rel, KV_RTOL[dtype])

    idx, y, err = obs
    glat_t = torch.as_tensor(glat, device=dev)
    glon_t = torch.as_tensor(glon, device=dev)
    general = MaternVariogram(psill=PSILL, range=RANGE_KM, nu=NU_GENERAL)
    half = MaternVariogram(psill=PSILL, range=RANGE_KM, nu=0.5)
    if tile_route(general) != "plain" or tile_route(half) != "kernel":
        raise AssertionError("the tile route is not chosen from nu")

    def krige(vario, dtype=torch.float32, e=err):
        return kriging_from_kernel(
            variogram_kernel(vario, "haversine"), glat_t.to(dtype),
            glon_t.to(dtype), idx, y.to(dtype), error_cov=e.to(dtype),
            variance=PSILL, method="ordinary", n_blocks=16)

    launches = COUNTS["k1.launches"]
    plain = COUNTS["k1.plain_tiles"]
    res, first_s = timed_s(lambda: krige(general))
    if COUNTS["k1.launches"] != launches:
        raise AssertionError("K1 launched at a general order")
    plain_tiles = require_launches("plain tile at a general order",
                                   COUNTS["k1.plain_tiles"] - plain)
    oracle = krige(general, torch.float64)
    errs = check_kriging(res, oracle, PSILL, f"nu={NU_GENERAL}")
    faults = {
        "nu_0.5_for_1.0": krige(half),
        "error_cov_x1.1": krige(general, e=1.1 * err),
    }
    faults = {k: max(kriging_errs(v, oracle, PSILL**0.5).values())
              for k, v in faults.items()}
    del oracle

    def median_wall(fn):
        return statistics.median(timed_s(fn)[1]
                                 for _ in range(GENERAL_REPEATS))

    wall_general = median_wall(lambda: krige(general))
    wall_k1 = median_wall(lambda: krige(half))
    la = torch.deg2rad(glat_t)
    lo = torch.deg2rad(glon_t)
    tile = (la[idx], lo[idx], la[:4096].contiguous(), lo[:4096].contiguous())
    general_tile_ms = cuda_time_ms(
        lambda: pairwise_covariance(*tile, general, "haversine"), iters=3)
    k1_tile_ms = cuda_time_ms(
        lambda: pairwise_covariance(*tile, half, "haversine"))
    phase(20, "kv_general", orders="|".join(map(str, KV_ORDERS)),
          x_range="1e-6..700",
          **{f"{name}_{str(dt)[6:]}_max_rel": f"{v:.3e}"
             for (dt, name), v in worst.items()},
          f64_bound=KV_RTOL[torch.float64], f32_bound=KV_RTOL[torch.float32],
          kriging_nu=NU_GENERAL, route="plain", plain_tiles=plain_tiles,
          tol=KRIGING_TOL,
          **{f"ordinary_{k}": f"{v:.3e}" for k, v in errs.items()},
          **{f"fault_{k}": f"{v:.3e}" for k, v in faults.items()},
          first_call_s=f"{first_s:.3f}",
          kriging_general_s=f"{wall_general:.4f}",
          kriging_k1_half_s=f"{wall_k1:.4f}",
          general_over_k1=f"{wall_general / wall_k1:.2f}",
          tile_5000x4096_general_ms=f"{general_tile_ms:.3f}",
          tile_5000x4096_k1_ms=f"{k1_tile_ms:.4f}")
    for k, v in faults.items():
        if not v > KRIGING_TOL:
            raise AssertionError(f"the bound {KRIGING_TOL} passes the fault "
                                 f"{k} ({v:.3e})")


def _angle(la1, lo1, la2, lo2):
    """Central angles (radians) between radian coordinates, broadcast."""
    a = (torch.sin((la1 - la2) / 2.0) ** 2 + torch.cos(la1) * torch.cos(la2)
         * torch.sin((lo1 - lo2) / 2.0) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def phase21_sphere_sampler(dev):
    """``SphericalHarmonicSampler`` at 1 degree: its build, its device
    table against the host f64 table, 100 members in f32 against f64,
    draws per second, and the covariance of 4,000 draws."""
    from glomargridding_tpu_torch.ops import sphere

    lat_axis, lon_axis = axes(SPHERE_DEG)
    corr = sphere.matern_correlation(0.5, RANGE_KM)
    sampler, build_s = timed_s(lambda: sphere.SphericalHarmonicSampler(
        corr, PSILL, lat_axis, lon_axis, nugget=SPHERE_NUGGET, device=dev))
    L = sampler.l_max
    _, power_s = timed_s(lambda: sphere.angular_power(corr, L, 4096))
    x = torch.as_tensor(np.sin(np.radians(lat_axis)), dtype=torch.float32,
                        device=dev)
    table, table_s = timed_s(lambda: sphere._legendre_table_device(x, L))
    _, dft_s = timed_s(lambda: torch.as_tensor(
        sphere.dft_tables(L, lon_axis), dtype=torch.float32, device=dev))
    table_err = float(np.abs(table.cpu().numpy()
                             - sphere.legendre_table(L, lat_axis)).max())
    del table
    check("device table vs host f64 table", table_err, SPHERE_TABLE_TOL)

    # 100 members in f32 and in f64 on the same normals
    M = lat_axis.size * lon_axis.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    noise = [torch.randn(s, dtype=torch.float64, device=dev, generator=gen)
             for s in ((N_MEMBERS, L + 1, L + 1),) * 2 + ((N_MEMBERS, M),)]
    f32 = sampler.draw(N_MEMBERS, noise=noise)
    sampler64 = sphere.SphericalHarmonicSampler(
        corr, PSILL, lat_axis, lon_axis, nugget=SPHERE_NUGGET,
        dtype=torch.float64, device=dev)
    f64 = sampler64.draw(N_MEMBERS, noise=noise)
    if f32.shape != (N_MEMBERS, M) or f32.dtype != torch.float32 or not bool(
            torch.isfinite(f32).all()):
        raise AssertionError("sampler draws malformed")
    draw_rel = check("f32 vs f64 draws", max_rel(f32, f64), SPHERE_F32_TOL)
    del noise, f32, f64, sampler64
    draw_s = wall_median_s(lambda: sampler.draw(N_MEMBERS, generator=gen))

    # the covariance of STAT_REFS cells with every cell, binned
    glat = np.repeat(lat_axis, lon_axis.size)
    glon = np.tile(lon_axis, lat_axis.size)
    la = torch.deg2rad(torch.as_tensor(glat, dtype=torch.float64, device=dev))
    lo = torch.deg2rad(torch.as_tensor(glon, dtype=torch.float64, device=dev))
    refs = torch.as_tensor(np.sort(np.random.default_rng(SEED).choice(
        M, STAT_REFS, replace=False)), device=dev)
    gamma = _angle(la[refs][:, None], lo[refs][:, None], la[None, :],
                   lo[None, :])
    same = refs[:, None] == torch.arange(M, device=dev)[None, :]
    n_bins = 1 + int(STAT_MAX_KM / STAT_BIN_KM)
    bins = torch.clamp(1 + (6371.0 * gamma / STAT_BIN_KM).long(),
                       max=n_bins)
    bins = torch.where(same, 0, bins).flatten()  # bin n_bins: dropped
    counts = torch.bincount(bins, minlength=n_bins + 1)[:n_bins].double()
    gamma_np = gamma.cpu().numpy()
    same_np = same.cpu().numpy()

    def expected(range_km):
        c = PSILL * sphere.matern_correlation(0.5, range_km)(gamma_np)
        c = torch.as_tensor(c + SPHERE_NUGGET * same_np, device=dev)
        return torch.bincount(bins, weights=c.flatten(),
                              minlength=n_bins + 1)[:n_bins] / counts

    batch_means = []
    _, stats_s = timed_s(lambda: batch_means.extend(
        torch.bincount(bins, weights=(D[:, refs].T @ D).flatten() / STAT_BATCH,
                       minlength=n_bins + 1)[:n_bins] / counts
        for D in (sampler.draw(STAT_BATCH, generator=gen).double()
                  for _ in range(STAT_DRAWS // STAT_BATCH))))
    batch_means = torch.stack(batch_means)
    mean = batch_means.mean(dim=0)
    se = batch_means.std(dim=0) / np.sqrt(batch_means.shape[0])
    allowance = PSILL * (1.0 - sampler.truncation_fraction)

    def sigmas(range_km):
        """max over bins of (|empirical - expected| - allowance) / SE"""
        return float(torch.max((torch.abs(mean - expected(range_km))
                                - allowance) / se))

    right, wrong = sigmas(RANGE_KM), sigmas(STAT_WRONG_RANGE * RANGE_KM)
    phase(21, "sphere_sampler_1deg", l_max=L, n_quad=4096,
          truncation_fraction=f"{sampler.truncation_fraction:.6f}",
          build_s=f"{build_s:.3f}", angular_power_s=f"{power_s:.3f}",
          device_table_s=f"{table_s:.3f}", dft_tables_s=f"{dft_s:.3f}",
          table_vs_host_f64=f"{table_err:.3e}",
          table_bound=SPHERE_TABLE_TOL, members=N_MEMBERS,
          f32_vs_f64=f"{draw_rel:.3e}", f32_bound=SPHERE_F32_TOL,
          draw_100_s=f"{draw_s:.4f}", draws_per_s=f"{N_MEMBERS / draw_s:.1f}",
          stat_draws=STAT_DRAWS, stat_refs=STAT_REFS, bins=n_bins,
          truncation_allowance=f"{allowance:.4f}",
          stat_se_max=f"{float(se.max()):.4f}",
          stat_sigmas=f"{right:.2f}", stat_bound=STAT_SIGMAS,
          stat_sigmas_wrong_range=f"{wrong:.2f}",
          wrong_range_km=STAT_WRONG_RANGE * RANGE_KM, stat_s=f"{stats_s:.2f}")
    check("covariance of the draws vs the kernel, standard errors", right,
          STAT_SIGMAS)
    if not wrong > STAT_SIGMAS:
        raise AssertionError(f"the bound passes the covariance at "
                             f"{STAT_WRONG_RANGE} x the range ({wrong:.2f})")


def phase22_chebyshev_mvn(dev):
    """``sample_mvn_chebyshev`` on the 2-degree grid through
    ``kernel_matvec`` (K1 tiles): the spectral range, 100 members in f32
    against f64, and p(C)(p(C) z) against C z. Returns K1's launches."""
    from glomargridding_tpu_torch import (
        MaternVariogram,
        chebyshev_apply,
        estimate_spectral_range,
        kernel_matvec,
        sample_mvn_chebyshev,
        variogram_kernel,
    )
    from glomargridding_tpu_torch.ops.sampling import (
        Matvec,
        chebyshev_sqrt_coeffs,
    )

    lats, lons = grid_linspace(*CHEB_GRID)
    n = lats.size
    kernel = variogram_kernel(MaternVariogram(psill=PSILL, range=RANGE_KM,
                                              nu=0.5), "haversine")

    def operator(dtype):
        la = torch.deg2rad(torch.as_tensor(lats, device=dev).to(dtype))
        lo = torch.deg2rad(torch.as_tensor(lons, device=dev).to(dtype))
        mv = kernel_matvec(kernel, la, lo, n_blocks=16)
        return Matvec(lambda v: mv(v) + SPHERE_NUGGET * v)

    C32 = operator(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    z = torch.randn((n, N_MEMBERS), dtype=torch.float64, device=dev,
                    generator=gen)
    COUNTS["k1.launches"] = 0
    (floor, lam_max), range_s = timed_s(
        lambda: estimate_spectral_range(C32, n, generator=gen, device=dev))
    # the nugget is the exact floor of C = K + nugget I (K is positive
    # semi-definite); the estimator's 1e-3 lam_max floor is above it here,
    # and an interval that starts above the spectrum is not honest
    lam_min = SPHERE_NUGGET
    degree = int(np.ceil(4.0 * np.sqrt(lam_max / lam_min)))
    y32, f32_s = timed_s(lambda: sample_mvn_chebyshev(
        C32, n, N_MEMBERS, lam_min, lam_max, degree, noise=z, device=dev))
    sync()
    k1_launches = require_launches("K1 (kernel_matvec)",
                                   COUNTS["k1.launches"])
    if k1_launches != 16 * (30 + degree):
        raise AssertionError(f"{k1_launches} K1 launches for "
                             f"{30 + degree} matvecs of 16 blocks")
    if y32.shape != (N_MEMBERS, n) or not bool(torch.isfinite(y32).all()):
        raise AssertionError("Chebyshev draws malformed")
    C64 = operator(torch.float64)
    y64, f64_s = timed_s(lambda: sample_mvn_chebyshev(
        C64, n, N_MEMBERS, lam_min, lam_max, degree, dtype=torch.float64,
        noise=z, device=dev))
    f32_rel = check("Chebyshev f32 vs f64 draws", max_rel(y32, y64),
                    CHEB_F32_TOL)
    del y32, y64
    # the expansion's accuracy on the interval, on the host, bounds
    # |p(C)^2 z - C z| / |C z| by eps (2 + eps)
    coeffs = chebyshev_sqrt_coeffs(lam_min, lam_max, degree)
    lam = np.unique(np.concatenate([
        np.geomspace(lam_min, lam_max, 100_001),
        np.linspace(lam_min, lam_max, 100_001)]))
    t = (2.0 * lam - (lam_max + lam_min)) / (lam_max - lam_min)
    eps = float(np.max(np.abs(np.polynomial.chebyshev.chebval(t, coeffs)
                              - np.sqrt(lam)) / np.sqrt(lam)))
    zz = z[:, :8]
    twice = chebyshev_apply(C64, chebyshev_apply(
        C64, zz, coeffs, lam_min, lam_max), coeffs, lam_min, lam_max)
    Cz = C64(zz)
    sq_rel = float(torch.linalg.norm(twice - Cz) / torch.linalg.norm(Cz))
    phase(22, "chebyshev_mvn_16200", members=N_MEMBERS,
          lam_max=f"{lam_max:.4f}", lam_min_floor=f"{floor:.4g}",
          lam_min=f"{lam_min:.4g}", degree=degree, k1_launches=k1_launches,
          spectral_range_s=f"{range_s:.3f}", draw_f32_s=f"{f32_s:.3f}",
          draw_f64_s=f"{f64_s:.3f}",
          ms_per_matvec_f32=f"{1e3 * f32_s / degree:.3f}",
          f32_vs_f64=f"{f32_rel:.3e}", f32_bound=CHEB_F32_TOL,
          expansion_eps=f"{eps:.3e}", p2_vs_C_f64=f"{sq_rel:.3e}",
          p2_bound=f"{eps * (2.0 + eps) + 1e-10:.3e}")
    check("p(C)^2 z vs C z (f64)", sq_rel, eps * (2.0 + eps) + 1e-10)
    return k1_launches


def phase23_variogram_mle(dev, glat, glon, obs):
    """``fit_variogram_mle`` at the main path's 5,000 positions, from a
    spherical-harmonic truth: L-BFGS and Nelder-Mead, f32 and f64, and a
    fit at nu = 1.0 through the general K_nu and its gradient."""
    from glomargridding_tpu_torch import (
        fit_variogram_mle,
        gp_negative_log_likelihood,
    )
    from glomargridding_tpu_torch.ops import sphere
    from glomargridding_tpu_torch.ops.distances import haversine_matrix

    idx = obs[0]
    m = idx.numel()
    sampler = sphere.SphericalHarmonicSampler(
        sphere.matern_correlation(1.5, RANGE_KM), PSILL, np.unique(glat),
        np.unique(glon), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    truth = sampler.draw(1, generator=gen)[0]
    y = (truth[idx] + np.sqrt(MLE_NOISE) * torch.randn(
        m, generator=gen, device=dev)).double()
    olat = torch.as_tensor(glat, dtype=torch.float64, device=dev)[idx]
    olon = torch.as_tensor(glon, dtype=torch.float64, device=dev)[idx]
    dists = {dt: haversine_matrix(olat.to(dt), olon.to(dt))
             for dt in (torch.float64, torch.float32)}
    fits, walls = {}, {}
    for dt, opt in product((torch.float64, torch.float32),
                           ("L-BFGS-B", "Nelder-Mead")):
        fits[dt, opt], walls[dt, opt] = timed_s(lambda: fit_variogram_mle(
            dists[dt], y.to(dt), nu=1.5, optimizer=opt))

    def nll(params, n=m, nu=1.5):
        return float(gp_negative_log_likelihood(
            torch.as_tensor(params, dtype=torch.float64, device=dev),
            dists[torch.float64][:n, :n], y[:n], kind="matern", nu=nu,
            method="sklearn"))

    truth_nll = nll([PSILL, RANGE_KM, MLE_NOISE])
    fit_nll = {k: nll(f[:3]) for k, f in fits.items()}
    best = fits[torch.float64, "Nelder-Mead"][:3]
    f32_nll_error = abs(float(gp_negative_log_likelihood(
        torch.as_tensor(best, dtype=torch.float32, device=dev),
        dists[torch.float32], y.float(), kind="matern", nu=1.5,
        method="sklearn")) - nll(best))
    nm_gap = (fit_nll[torch.float32, "Nelder-Mead"]
              - fit_nll[torch.float64, "Nelder-Mead"])

    def rel(a, b):
        return max(abs(p - q) / abs(q) for p, q in zip(a[:3], b[:3]))

    f32_rel = {opt: rel(fits[torch.float32, opt], fits[torch.float64, opt])
               for opt in ("L-BFGS-B", "Nelder-Mead")}
    opt_rel = rel(fits[torch.float64, "L-BFGS-B"],
                  fits[torch.float64, "Nelder-Mead"])
    # nu = 1.0 on the first MLE_GENERAL_N observations, by L-BFGS: the
    # gradient through the general K_nu
    sub = (dists[torch.float64][:MLE_GENERAL_N, :MLE_GENERAL_N],
           y[:MLE_GENERAL_N])
    torch.cuda.reset_peak_memory_stats()
    general, general_s = timed_s(lambda: fit_variogram_mle(
        *sub, nu=NU_GENERAL, optimizer="L-BFGS-B"))
    general_gb = torch.cuda.max_memory_allocated() / 1e9

    def show(fit):
        return f"{fit.psill:.5g}|{fit.range:.6g}|{fit.nugget:.5g}"

    phase(23, "variogram_mle_5000", n=m, nu=1.5,
          truth=f"{PSILL}|{RANGE_KM}|{MLE_NOISE}",
          truncation_fraction=f"{sampler.truncation_fraction:.6f}",
          **{f"{str(dt)[6:]}_{opt}": f"{show(f)} nit={f.nit} "
             f"ok={int(f.success)} s={walls[dt, opt]:.3f}"
             for (dt, opt), f in fits.items()},
          **{f"f32_vs_f64_{opt}": f"{v:.3e}" for opt, v in f32_rel.items()},
          f32_bound=MLE_F32_RTOL, f32_nll_error=f"{f32_nll_error:.4f}",
          f32_nm_nll_gap=f"{nm_gap:.4f}", f32_nm_gap_bound=MLE_F32_NLL_GAP,
          lbfgs_vs_nm_f64=f"{opt_rel:.3e}",
          opt_bound=MLE_OPT_RTOL, nll_truth_f64=f"{truth_nll:.6f}",
          **{f"nll_{str(dt)[6:]}_{opt}_f64": f"{v:.6f}"
             for (dt, opt), v in fit_nll.items()},
          general_n=MLE_GENERAL_N,
          general_lbfgs=f"{show(general)} nit={general.nit} "
                        f"ok={int(general.success)} s={general_s:.3f}",
          general_peak_gb=f"{general_gb:.2f}")
    check("variogram MLE f32 vs f64, L-BFGS", f32_rel["L-BFGS-B"],
          MLE_F32_RTOL)
    check("variogram MLE f32 Nelder-Mead: f64 NLL over the f64 fit's",
          nm_gap, MLE_F32_NLL_GAP)
    check("variogram MLE L-BFGS vs Nelder-Mead, f64", opt_rel, MLE_OPT_RTOL)
    for k, v in fit_nll.items():
        if not v <= truth_nll:
            raise AssertionError(f"the {k} fit's NLL {v:.6f} is above the "
                                 f"truth's {truth_nll:.6f}")
    if not (general.success and np.isfinite(general.nll)):
        raise AssertionError(f"the nu = {NU_GENERAL} fit failed: {general}")


def pipeline_consistency(res, members, truth):
    """Phase 24's RMSE, mean uncertainty and member spread."""
    return {
        "rmse": torch.sqrt(torch.mean((res.field - truth) ** 2)).item(),
        "mean_uncertainty": res.uncertainty.mean().item(),
        "member_spread": (members - res.field).std(dim=0).mean().item(),
    }


def pipeline_stages(tp, dev, gen, stages):
    """examples/torch_nonstationary_1deg_pipeline.py's stages at 1 degree
    through the twin's stage functions, timed into `stages`: (the kept
    cells' factors, their rank and trace change, the observations, the
    kriging and members, the QC codes and mask, K2's launches)."""

    lats, lons = tp.axes()
    mask, stages["mask"] = timed_s(lambda: tp.ocean_mask(lats, lons))
    n_ocean = int((~mask).sum())
    if n_ocean != PIPE_OCEAN:
        raise AssertionError(f"{n_ocean} ocean cells, not {PIPE_OCEAN}")

    def cube_stage():
        sampler = tp.training_sampler(lats, lons, device=dev)
        return sampler, tp.training_cube(sampler, mask, gen)

    (sampler, cube), stages["cube"] = timed_s(cube_stage)
    builder, stages["calc_cov"] = timed_s(lambda: tp.correlation(cube, lats,
                                                                 lons))
    del cube
    COUNTS["k5.launches"] = 0
    params, stages["fit"] = timed_s(lambda: tp.fit_ellipses(builder))
    k5_launches = require_launches("K5 (the pipeline's fit)",
                                   COUNTS["k5.launches"])
    del builder
    left_out, good = tp.fit_mask(params, mask)
    reset_ellipse_counts()
    cov, stages["assembly"] = timed_s(lambda: tp.assembly(
        params, left_out, lats, lons, dev))
    k2_launches = require_launches("K2 (the pipeline's assembly)",
                                   COUNTS["k2.launches"])
    n = cov.shape[0]
    (psd, true_rank, trace_rel), stages["clip"] = timed_s(
        lambda: tp.psd_repair(cov, generator=gen))
    del cov
    obs, stages["observations"] = timed_s(lambda: tp.observations(
        sampler, left_out, n, gen))
    idx, truth, y, e = obs
    (res, members), stages["kriging_100"] = timed_s(
        lambda: tp.ensemble(psd, idx, y, e, gen))
    qc = np.asarray(params["qc_code"].values)
    return dict(psd=psd, true_rank=true_rank, trace_rel=trace_rel, obs=obs,
                res=res, members=members, qc=qc, mask=mask, good=good,
                n=n, k2_launches=k2_launches, k5_launches=k5_launches,
                n_ocean=n_ocean)


def phase24_nonstationary_pipeline(dev):
    """examples/torch_nonstationary_1deg_pipeline.py at 1 degree, nothing
    cut, stage by stage through the twin: training cube -> calc_cov ->
    ellipse fit -> K2 -> clip -> kriging with 100 members. Returns K2's
    and K5's launches."""
    from glomargridding_tpu_torch import (
        LowRankPSD,
        lowrank_ensemble_step,
        lowrank_kriging,
    )

    tp = examples_module("torch_nonstationary_1deg_pipeline")
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = pipeline_stages(tp, dev, gen, stages)
    psd, res, members = out["psd"], out["res"], out["members"]
    idx, truth, y, e = out["obs"]
    n, qc, mask = out["n"], out["qc"], out["mask"]
    n_obs = idx.numel()
    qc0_share = float(np.sum((qc == 0) & ~mask) / out["n_ocean"])
    codes, counts = np.unique(qc[~mask], return_counts=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, got in (*zip(res._fields, res), ("members", members)):
        if got.shape[-1] != n or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"pipeline {name} malformed")
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    errs = kriging_errs(res, lowrank_kriging(psd64, idx, y, e),
                        float(torch.sqrt(psd.diagonal().max())))
    del psd64

    # the example's truth is the stationary exponential field plus its
    # nugget, which the fitted nu = 1.5 ellipses do not describe: its
    # RMSE is printed, and only the ensemble is held to its uncertainty.
    # As in phase 14, a truth drawn from the factors holds all three.
    example = pipeline_consistency(res, members, out["obs"][1])
    model_truth = psd.draw(1, generator=gen)[0]
    y_model = model_truth[idx] + np.sqrt(tp.OBS_ERROR) * torch.randn(
        n_obs, generator=gen, device=dev)
    triple = pipeline_consistency(*lowrank_ensemble_step(
        psd, idx, y_model, e, gen, N_MEMBERS), model_truth)
    example_ratio = example["rmse"] / example["mean_uncertainty"]
    phase(24, "nonstationary_1deg_pipeline", ocean=out["n_ocean"],
          T=tp.T_TRAIN, l_max=tp.L_MAX, fitted=int(out["good"].sum()), n=n,
          qc_counts="|".join(f"{c}:{k}" for c, k in zip(codes, counts)),
          qc0_share=f"{qc0_share:.4f}", qc0_bound=PIPE_QC0_SHARE,
          k2_launches=out["k2_launches"], k5_launches=out["k5_launches"],
          rank=f"{out['true_rank']}->{psd.rank}",
          trace_rel=f"{out['trace_rel']:.3e}", trace_tol=TRACE_TOL,
          obs=n_obs, members=N_MEMBERS, tol=KRIGING_TOL,
          **{f"f32_vs_f64_{k}": f"{v:.3e}" for k, v in errs.items()},
          **{f"example_{k}": f"{v:.4f}" for k, v in example.items()},
          example_rmse_over_uncertainty=f"{example_ratio:.4f}",
          **{f"consistency_{k}": f"{v:.4f}" for k, v in triple.items()},
          consistency_ratio_bound=CONSISTENCY_RATIO,
          **{f"{k}_s": f"{v:.3f}" for k, v in stages.items()},
          total_s=f"{sum(stages.values()):.3f}", peak_gb=f"{peak_gb:.3f}")
    if not qc0_share >= PIPE_QC0_SHARE:
        raise AssertionError(f"QC 0 on {qc0_share:.4f} of the ocean")
    check("pipeline trace of the factors", out["trace_rel"], TRACE_TOL)
    for k, v in errs.items():
        check(f"pipeline f32 vs f64 {k}", v, KRIGING_TOL)
    spread_ratio = example["member_spread"] / example["mean_uncertainty"]
    check("pipeline members: spread over uncertainty, either way",
          max(spread_ratio, 1.0 / spread_ratio), CONSISTENCY_RATIO)
    check("pipeline consistency, a truth drawn from the factors: largest "
          "over smallest of RMSE, mean uncertainty and member spread",
          max(triple.values()) / min(triple.values()), CONSISTENCY_RATIO)
    return out["k2_launches"], out["k5_launches"]


def sampling_and_fitting(dev, glat, glon, obs):
    """Phases 20-24; returns K1's launches on ``kernel_matvec`` and K2's
    and K5's on the pipeline."""
    phase20_kv_general(dev, glat, glon, obs)
    phase21_sphere_sampler(dev)
    k1_matvec = phase22_chebyshev_mvn(dev)
    phase23_variogram_mle(dev, glat, glon, obs)
    k2_pipeline, k5_pipeline = phase24_nonstationary_pipeline(dev)
    return k1_matvec, k2_pipeline, k5_pipeline


# ---------------------------------------------------------------------------
# phases 25-27: the host-side modules on their paths
# ---------------------------------------------------------------------------
def examples_module(name):
    """Import a module of ``examples/`` (the paths users run)."""
    import importlib
    import os

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")
    if here not in sys.path:
        sys.path.insert(0, here)
    return importlib.import_module(name)


def workflow_errs(a, b, keys):
    """Each output of `keys` of one workflow run against another's: a
    field relative to max |field|, an uncertainty to the sill's root, a
    constraint mask absolute."""
    out = {}
    for key in keys:
        scale = (PSILL**0.5 if key.startswith("uncert")
                 else 1.0 if key.startswith("mask") else None)
        if not bool(torch.isfinite(a[key]).all()):
            raise AssertionError(f"non-finite {key}")
        out[key] = max_rel(a[key], b[key], scale)
    return out


STATIONARY_KEYS = ("anom_stat", "uncert_stat", "mask_stat")
NON_STATIONARY_KEYS = ("anom_non_stat", "uncert_non_stat", "mask_non_stat",
                       "perturbed_anom")


def first_call_costs(wf, dev):
    """What the workflow's first stage spends on its first call in this
    process, paid here so that the timed runs do not carry it: the
    ``import pandas`` that the distance matrix makes, then the stage once
    under cProfile (its five costliest functions by own time) and once
    more."""
    import cProfile
    import importlib
    import os
    import pstats

    loaded = "pandas" in sys.modules
    t0 = time.perf_counter()
    importlib.import_module("pandas")
    pandas_s = time.perf_counter() - t0
    grid = wf.global_grid()
    prof = cProfile.Profile()
    sync()
    t0 = time.perf_counter()
    prof.enable()
    wf.stationary_covariance(grid, torch.float32, dev)
    sync()
    prof.disable()
    first_s = time.perf_counter() - t0
    _, second_s = timed_s(
        lambda: wf.stationary_covariance(grid, torch.float32, dev))
    own = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: kv[1][2], reverse=True)[:5]
    top = "|".join(f"{os.path.basename(f)}:{name}={v[2]:.4f}"
                   for (f, _, name), v in own)
    print(f"phase 25 first_call pandas_loaded_before={loaded} "
          f"pandas_import_s={pandas_s:.4f} "
          f"stationary_covariance_first_s={first_s:.4f} (under cProfile) "
          f"stationary_covariance_second_s={second_s:.4f} "
          f"first_call_own_s={top}", flush=True)


def workflow_oracle(wf, load, fields, lat, lon, dev, eras):
    """The workflow's stages after the fit in f64 on the card, on the
    ellipses `fields`, for each (year, member) of `eras`; returns
    ({year: outputs}, the step pairs, K2's errors).

    K2 first: its f32 and f64 builds of the fitted points are the
    builders' covariances bit for bit, and each is held against the plain
    K2 on the same points to ELLIPSE_RTOL, every pair included. The f64
    covariance then takes the pairs of fitted points exactly 180 degrees
    of longitude apart from the f32 build: at those pairs the reference's
    formula has a step (the wrap of a +-pi longitude difference, which f32
    and f64 take to opposite sides for a rotated ellipse; 7.1e-3 of max
    |C| on the stored run's ellipses, 2.0e-7 at every other pair, in the
    JAX package as in the port, ``tests/test_torch_workflow.py``), so f64
    there would measure the step, not f32's rounding."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    f32, f64 = torch.float32, torch.float64
    builders = {d: wf.ellipse_covariance(fields, lat, lon, d, dev)
                for d in (f32, f64)}
    k2_err = {}
    for dtype, b in builders.items():
        tag = "f64" if dtype == f64 else "f32"
        P = builder_points(b)
        args = (b.v, b.delta_x_method, b.max_dist)
        k2 = te.ellipse_sym(P, *args)
        if not torch.equal(k2, b.cov_ns):
            raise AssertionError(f"the {tag} builder's covariance is not K2's")
        k2_err[tag] = check(
            f"K2 at the workflow's {P.shape[0]} points, {tag}",
            max_rel(k2, te.ellipse_sym_torch(P, *args)), ELLIPSE_RTOL[dtype])
        del k2
    b32, b64 = builders[f32], builders[f64]
    fitted = np.asarray(fields["Lx"]).reshape(-1) > 0
    lons = np.tile(np.asarray(lon, np.float64), len(lat))[fitted]
    step = torch.as_tensor(np.abs(lons[:, None] - lons[None, :]) == 180.0,
                           device=dev)
    b64.cov_ns = torch.where(step, b32.cov_ns.to(f64), b64.cov_ns)
    covs = {"stat": wf.stationary_covariance(wf.global_grid(), f64, dev),
            "non_stat": wf.repaired_covariance(b64)}
    out = {}
    for year, member in eras:
        error_cov = wf.error_covariance(load, year)
        idx, obs = wf.member_observations(load, wf.global_grid(), year,
                                          member)
        o = out[year] = {}
        for name, cov in covs.items():
            (o[f"anom_{name}"], o[f"uncert_{name}"],
             o[f"mask_{name}"]) = wf.krige(cov, idx, obs, error_cov)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        o["perturbed_anom"] = wf.perturbed_member(
            covs["non_stat"], idx, obs, error_cov, gen)
    return out, int(step.sum()), k2_err


def workflow_fit_shares(wf, load, dev, params):
    """Phase 25's fits: the f32 fit against the f64 fit by share of lanes
    within the bounds, and the nu = 0.5 control that must fall under
    them."""
    f32, f64 = torch.float32, torch.float64
    cube, lat, lon, coords = wf.training_cube(load, f64)
    fit64, fit64_s = timed_s(lambda: wf.fit_ellipses(cube, coords, dev))
    cube, _, _, coords = wf.training_cube(load, f32)
    wrong, wrong_s = timed_s(lambda: wf.fit_ellipses(cube, coords, dev,
                                                     v=0.5))
    del cube

    def rows(p):
        return np.stack([np.asarray(p[n].values).reshape(-1)
                         for n in ("Lx", "Ly", "theta")], axis=1)

    def qc0(p):
        return np.asarray(p["qc_code"].values).reshape(-1) == 0

    fitted = rows(params)[:, 0] > 0
    if not np.array_equal(fitted, rows(fit64)[:, 0] > 0):
        raise AssertionError("the f32 and f64 fits cover other points")
    keep = fitted & qc0(params) & qc0(fit64)
    dev_fit = fit_deviation(rows(params), rows(fit64), keep)
    shares = {n: share_within(dev_fit, [n]) for n in dev_fit}
    keep_wrong = fitted & qc0(wrong) & qc0(fit64)
    dev_wrong = fit_deviation(rows(wrong), rows(fit64), keep_wrong)
    wrong_shares = {n: share_within(dev_wrong, [n]) for n in dev_wrong}
    for name in ("Lx_rel", "Ly_rel"):
        check(f"workflow fit {name}: share of lanes off the f64 fit",
              1.0 - shares[name], 1.0 - WORKFLOW_FIT_SHARE)
        if not wrong_shares[name] < WORKFLOW_FIT_SHARE:
            raise AssertionError(
                f"the nu = 0.5 control passes the fit's bound on {name}: "
                f"{wrong_shares[name]:.4f} >= {WORKFLOW_FIT_SHARE}")
    return dict(fitted=fitted, fit64=fit64, lat=lat, lon=lon, shares=shares,
                keep=keep, wrong_shares=wrong_shares, keep_wrong=keep_wrong,
                fit64_s=fit64_s, wrong_s=wrong_s)


def workflow_vs_f64(wf, load, params, lat, lon, dev, out32, old32):
    """The 2014 and 1876 f32 runs against the f64 oracle on the f32 run's
    ellipses: (errors 2014, errors 1876, the step pairs, K2's errors)."""
    fields = {n: params[n].values for n in ("Lx", "Ly", "theta",
                                            "standard_deviation")}
    oracle, step_pairs, k2_err = workflow_oracle(
        wf, load, fields, lat, lon, dev,
        ((wf.YEAR, wf.MEMBER), SPARSE_ERA))
    errs = workflow_errs(out32, oracle[wf.YEAR],
                         STATIONARY_KEYS + NON_STATIONARY_KEYS)
    errs_old = workflow_errs(old32, oracle[SPARSE_ERA[0]],
                             STATIONARY_KEYS + NON_STATIONARY_KEYS)
    for label, e in (("2014", errs), ("1876", errs_old)):
        bad = {k: v for k, v in e.items() if not v <= WORKFLOW_TOL}
        if bad:
            raise AssertionError(f"workflow {label}: f32 vs f64 {bad}")
    return errs, errs_old, step_pairs, k2_err


def workflow_vs_stored(out32, fit64, fitted, dev):
    """The 2014 run against the stored TPU run: the stationary fields
    (held), the non-stationary field and the f64 fit's ellipses
    (printed)."""
    with np.load(STORED_RUN) as z:
        stored = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
    if not np.array_equal(out32["grid_idx"], stored["grid_idx"].cpu()):
        raise AssertionError("the 2014 gridboxes differ from the stored run")
    vs_stored = {
        "anom_stat": check("stationary field vs the stored run",
                           max_rel(out32["anom_stat"], stored["anom_stat"]),
                           STORED_TOL),
        "uncert_stat": check("stationary uncertainty vs the stored run",
                             max_rel(out32["uncert_stat"],
                                     stored["uncert_stat"], PSILL**0.5),
                             STORED_TOL)}
    # not bounded: the stored non-stationary fields come from another
    # state of the fit (its ellipses differ from today's f64 fit)
    gap = (out32["anom_non_stat"].double() - stored["anom_non_stat"]).abs()
    stored_rel = max_rel(out32["anom_non_stat"], stored["anom_non_stat"])
    stored_share = {
        n: float(np.mean(np.abs(np.asarray(fit64[n].values)[fitted.reshape(
            36, 72)] / stored[f"ellipse_{n}"].cpu().numpy()[fitted.reshape(
                36, 72)] - 1.0) <= FIT_REL_TOL)) for n in ("Lx", "Ly")}
    return vs_stored, gap, stored_rel, stored_share


def phase25_hadsst_workflow(dev):
    """examples/torch_hadsst_workflow.py on the card with nothing cut: the
    5-degree grid (2,592 cells), the ellipse fit on the whole 41-March
    ESA-CCI cube, K2, the f64 clip, HadCRUT5's 2,592-cell error
    covariance, March 2014 (member 71) and March 1876 (member 94, the
    sparse era, the same ellipses). Each f32 run (the stationary
    covariance and kriging, the cube, the fit and K2 in f32; the clip and
    what follows it in f64, as the example has it) against the same
    stages in f64 on the card, on the f32 run's ellipses
    (``workflow_oracle``, which also holds K2 at these points against its
    plain twin); the f32 fit against the f64 fit by share of lanes, and
    the f32 fit at the wrong order (nu = 0.5) as the control that must
    fall under that bound; the stationary fields against the stored TPU
    run. Returns K2's launches."""

    wf = examples_module("torch_hadsst_workflow")
    load = examples_module("torch_workflow_data").bundle_loader()
    f32, f64 = torch.float32, torch.float64

    def run(dtype, **kw):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return wf.run(device=dev, dtype=dtype, load=load, generator=gen,
                      verbose=False, **kw)

    first_call_costs(wf, dev)
    reset_ellipse_counts()
    COUNTS["k5.launches"] = 0  # the workflow's fits, the controls' below
    out32, wall = timed_s(lambda: run(f32))
    k2 = require_launches("K2 on the 5-degree workflow",
                          COUNTS["k2.launches"])
    params = out32["ellipse_params"]
    sparse = dict(zip(("year", "member"), SPARSE_ERA))
    reset_ellipse_counts()
    old32, old_wall = timed_s(lambda: run(f32, ellipse_params=params,
                                          **sparse))
    k2 += require_launches("K2 on the 1876 workflow",
                           COUNTS["k2.launches"])

    fit = workflow_fit_shares(wf, load, dev, params)
    k5 = require_launches("K5 in the workflow's fits", COUNTS["k5.launches"])
    fitted, fit64, lat, lon = fit["fitted"], fit["fit64"], fit["lat"], fit[
        "lon"]
    errs, errs_old, step_pairs, k2_err = workflow_vs_f64(
        wf, load, params, lat, lon, dev, out32, old32)
    cv = {f"{k}_{s}": float(getattr(out32[f"cv_{k}"], s))
          for k in ("stat", "non_stat") for s in ("rmse", "mssr")}

    vs_stored, gap, stored_rel, stored_share = workflow_vs_stored(
        out32, fit64, fitted, dev)
    phase(25, "hadsst_workflow_5deg", cells=2592,
          fitted=int(fitted.sum()), obs_2014=len(out32["grid_idx"]),
          obs_1876=len(old32["grid_idx"]), k2_launches=k2, tol=WORKFLOW_TOL,
          **{f"k2_vs_plain_{k}": f"{v:.3e}" for k, v in k2_err.items()},
          k2_bounds=f"f64:{ELLIPSE_RTOL[f64]}|f32:{ELLIPSE_RTOL[f32]}",
          **{f"f32_vs_f64_{k}": f"{v:.3e}" for k, v in errs.items()},
          **{f"f32_vs_f64_1876_{k}": f"{v:.3e}"
             for k, v in errs_old.items()},
          step_pairs=step_pairs,
          **{f"fit_share_{k}": f"{v:.4f}" for k, v in fit["shares"].items()},
          fit_lanes=int(fit["keep"].sum()),
          fit_share_bound=WORKFLOW_FIT_SHARE,
          **{f"control_nu05_share_{k}": f"{v:.4f}"
             for k, v in fit["wrong_shares"].items()},
          control_lanes=int(fit["keep_wrong"].sum()),
          **{f"stored_{k}": f"{v:.3e}" for k, v in vs_stored.items()},
          stored_tol=STORED_TOL,
          stored_non_stat_max_abs=f"{gap.max().item():.4f}",
          stored_non_stat_rel=f"{stored_rel:.3e}",
          **{f"stored_ellipse_share_{k}": f"{v:.4f}"
             for k, v in stored_share.items()},
          **{f"cv_{k}": f"{v:.4f}" for k, v in cv.items()},
          run_2014_s=f"{wall:.3f}", run_1876_s=f"{old_wall:.3f}",
          fit_f64_s=f"{fit['fit64_s']:.3f}",
          fit_nu05_f32_s=f"{fit['wrong_s']:.3f}",
          k5_launches=k5, inputs="bundle")
    print("phase 25 stages_s " + " ".join(
        f"{k.replace(' ', '_')}={v:.4f}" for k, v in out32["times"].items()),
        flush=True)
    print("phase 25 stages_1876_s " + " ".join(
        f"{k.replace(' ', '_')}={v:.4f}" for k, v in old32["times"].items()),
        flush=True)
    return k2, k5


def scan_tiles_vs_plain(scan, load, dev):
    """K1 on every tile the months scan asks of it (each month's K over
    its padded slots and its row blocks over the grid, as
    ``months_scan_kriging`` cuts them), in f32 and f64, against the plain
    tile on the same inputs, relative to the kernel's variance, to
    TILE_RTOL. Returns the largest error of each precision."""
    from glomargridding_tpu_torch.models.kernel_kriging import _blocks, _grid
    from glomargridding_tpu_torch.ops.cuda.pairwise import (
        pairwise_covariance_torch,
    )

    kernel = scan.scan_kernel()
    plain = (kernel.variogram, kernel.distance, kernel.var, kernel.radius)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f64" if dtype == torch.float64 else "f32"
        glat, glon, idx_m, *_ = scan.month_observations(load, dtype)
        la, lo = _grid(glat, glon, dev)
        idx_m = torch.as_tensor(idx_m, device=dev).long()
        worst[tag] = 0.0
        for t in range(idx_m.shape[0]):
            la_o, lo_o = la[idx_m[t]], lo[idx_m[t]]
            blocks = _blocks(la.shape[0], scan.N_BLOCKS)
            cols = [(la_o, lo_o)] + [(la[a:b], lo[a:b]) for a, b in blocks]
            for la_c, lo_c in cols:
                rel = max_rel(kernel(la_o, lo_o, la_c, lo_c),
                              pairwise_covariance_torch(
                                  la_o, lo_o, la_c, lo_c, *plain),
                              kernel.var)
                worst[tag] = max(worst[tag], check(
                    f"K1 scan tile {tag} month {t} "
                    f"{la_o.shape[0]}x{la_c.shape[0]}", rel,
                    TILE_RTOL[dtype]))
    return worst


def phase26_esa_months_scan(dev):
    """examples/torch_esa_months_scan.py on the card: 41 Marches, padded
    and kriged by ``months_scan_kriging`` (K1 tiles), without and with
    the diagnostics, f32 against f64. Returns K1's launches."""

    scan = examples_module("torch_esa_months_scan")
    load = examples_module("torch_workflow_data").bundle_loader()
    COUNTS["k1.launches"] = 0
    out32 = scan.run(device=dev, dtype=torch.float32, load=load,
                     verbose=False)
    sync()
    k1 = require_launches("K1 on the months scan",
                          COUNTS["k1.launches"])
    out64 = scan.run(device=dev, dtype=torch.float64, load=load,
                     verbose=False)
    k1_err = scan_tiles_vs_plain(scan, load, dev)
    keys = {"fields": None, "fields_only": None,
            "uncertainty": PSILL**0.5, "constraint_mask": 1.0}
    errs = {}
    for key, scale in keys.items():
        if not bool(torch.isfinite(out32[key]).all()):
            raise AssertionError(f"non-finite {key}")
        errs[key] = check(f"months scan {key}, f32 vs f64",
                          max_rel(out32[key], out64[key], scale),
                          WORKFLOW_TOL)
    n_months = out32["fields"].shape[0]
    if tuple(out32["fields"].shape) != (41, 2592):
        raise AssertionError(f"fields {tuple(out32['fields'].shape)}")
    counts = out32["counts"]
    phase(26, "esa_months_scan", months=n_months,
          obs_per_month=f"{min(counts)}..{max(counts)}", k1_launches=k1,
          **{f"k1_vs_plain_{k}": f"{v:.3e}" for k, v in k1_err.items()},
          k1_bounds=f"f64:{TILE_RTOL[torch.float64]}"
                    f"|f32:{TILE_RTOL[torch.float32]}",
          tol=WORKFLOW_TOL,
          **{f"f32_vs_f64_{k}": f"{v:.3e}" for k, v in errs.items()},
          **{f"f32_{k.replace(' ', '_').replace('+', '_')}_ms_per_month":
             f"{v / n_months * 1e3:.4f}" for k, v in out32["times"].items()},
          **{f"f64_{k.replace(' ', '_').replace('+', '_')}_ms_per_month":
             f"{v / n_months * 1e3:.4f}" for k, v in out64["times"].items()})
    return k1


def raw_observations(glat, glon, idx, y):
    """RAW_OBS raw observations over the cells `idx` (sorted): 1 to
    RAW_MAX_PER_BOX a box, summing to RAW_OBS, positions jittered within
    RAW_JITTER_DEG of the centre, values y + N(0, RAW_NOISE). numpy f64;
    also the box each came from."""
    rng = np.random.default_rng(SEED + 27)
    n = idx.size
    weights = rng.integers(1, RAW_MAX_PER_BOX + 1, n)
    counts = np.clip(np.floor(weights * RAW_OBS / weights.sum()), 1,
                     RAW_MAX_PER_BOX).astype(np.int64)
    while counts.sum() != RAW_OBS:  # top up (or trim) boxes in range
        short = RAW_OBS - counts.sum()
        room = np.nonzero(counts < RAW_MAX_PER_BOX if short > 0
                          else counts > 1)[0]
        pick = rng.choice(room, min(abs(short), room.size), replace=False)
        counts[pick] += np.sign(short)
    box = np.repeat(idx, counts)
    lats = glat[box] + rng.uniform(-RAW_JITTER_DEG, RAW_JITTER_DEG, RAW_OBS)
    lons = glon[box] + rng.uniform(-RAW_JITTER_DEG, RAW_JITTER_DEG, RAW_OBS)
    values = np.repeat(y, counts) + RAW_NOISE * rng.normal(size=RAW_OBS)
    return lats, lons, values, box, counts


def observation_records(glat, glon, idx):
    """RECORDS_PER_BOX records a box: a frame with the box's 1-d index,
    position, a data type and a platform."""
    import pandas as pd

    rng = np.random.default_rng(SEED + 28)
    box = np.repeat(idx, RECORDS_PER_BOX)
    n = box.size
    return pd.DataFrame({
        "grid_idx": box,
        "lat": glat[box] + rng.uniform(-RAW_JITTER_DEG, RAW_JITTER_DEG, n),
        "lon": glon[box] + rng.uniform(-RAW_JITTER_DEG, RAW_JITTER_DEG, n),
        "data_type": rng.choice(list(RECORD_SIGMA), n),
        "platform": rng.integers(0, N_PLATFORMS, n),
    })


def phase27_raw_observations(dev):
    """Raw observations to a 1-degree field: RAW_OBS observations over the
    main path's 5,000 cells through ``aggregate_observations`` on the
    card against a numpy f64 oracle; 2 records a box through the
    observation-error components, ``get_weights`` and
    ``gridbox_error_covariance`` (a dense 5,000^2 error covariance); then
    ``kriging_from_kernel`` at 64,800 cells (K1), f32 against f64.
    Returns K1's launches."""
    from glomargridding_tpu_torch import (
        aggregate_observations,
        correlated_components,
        get_weights,
        grid_from_resolution,
        gridbox_error_covariance,
        kriging_from_kernel,
        uncorrelated_components,
        variogram_kernel,
        MaternVariogram,
    )

    grid = grid_from_resolution(1, [(-89.5, 90), (-179.5, 180)],
                                ["lat", "lon"])
    glat = np.repeat(grid.coords["lat"], grid.shape[1])
    glon = np.tile(grid.coords["lon"], grid.shape[0])
    idx_t, y_t, _ = observations(glat.size, dev)
    idx, y = idx_t.cpu().numpy(), y_t.cpu().numpy().astype(np.float64)
    (lats, lons, values, box, counts), gen_s = timed_s(
        lambda: raw_observations(glat, glon, idx, y))

    def ingest():
        return aggregate_observations(lats, lons, values, grid, device=dev)

    (u, means, n), first_s = timed_s(ingest)
    walls = []
    for _ in range(REPEATS):
        walls.append(timed_s(ingest)[1])
    ingest_s = statistics.median(walls)
    t0 = time.perf_counter()
    oracle_sum = np.bincount(box, weights=values, minlength=glat.size)
    oracle_count = np.bincount(box, minlength=glat.size)
    oracle_box = np.nonzero(oracle_count)[0]
    oracle_mean = oracle_sum[oracle_box] / oracle_count[oracle_box]
    oracle_s = time.perf_counter() - t0
    # a box's sum is conditioned by the sum of its values' magnitudes:
    # summed in any order its error is below (count - 1) u sum |v|
    # (Higham, Accuracy and Stability, 4.2), so each mean is held
    # relative to its box's mean |value|, which any order of atomics
    # meets with room (800 x 1.1e-16); relative to the mean itself a box
    # whose values cancel has no bound, and that is printed only
    oracle_abs = (np.bincount(box, weights=np.abs(values),
                              minlength=glat.size)[oracle_box]
                  / oracle_count[oracle_box])
    if not (np.array_equal(u.cpu().numpy(), oracle_box)
            and np.array_equal(n.cpu().numpy(), oracle_count[oracle_box])
            and np.array_equal(oracle_box, idx)):
        raise AssertionError("aggregate_observations: boxes or counts "
                             "differ from the numpy oracle")
    mean_gap = np.abs(means.cpu().numpy() - oracle_mean)
    mean_rel = check("aggregate_observations means vs numpy f64",
                     float(np.max(mean_gap / oracle_abs)), RAW_MEAN_RTOL)

    t0 = time.perf_counter()
    records = observation_records(glat, glon, idx)
    rng = np.random.default_rng(SEED + 29)
    bias = dict(enumerate(rng.uniform(*PLATFORM_BIAS_RANGE, N_PLATFORMS)))
    E = uncorrelated_components(records, "data_type",
                                obs_sig_map=RECORD_SIGMA)
    E += correlated_components(records, "platform", bias_sig_map=bias)
    W = get_weights(records)
    host_s = time.perf_counter() - t0
    Eg = {dtype: gridbox_error_covariance(W.astype(np_dtype), E,
                                          device=dev)
          for dtype, np_dtype in ((torch.float32, np.float32),
                                  (torch.float64, np.float64))}
    wewt_ms = cuda_time_ms(lambda: gridbox_error_covariance(
        W.astype(np.float32), E, device=dev), iters=3)
    wewt_err = check("W E W' f32 vs f64", max_rel(Eg[torch.float32],
                                                  Eg[torch.float64]),
                     GRIDBOX_ERROR_RTOL[torch.float32])
    # the f64 product against the host's
    host_wewt = W @ E @ W.T
    wewt_host_err = check(
        "W E W' f64 on the card vs numpy", max_rel(
            Eg[torch.float64], torch.as_tensor(host_wewt, device=dev)),
        GRIDBOX_ERROR_RTOL[torch.float64])
    del E, W, host_wewt

    kernel = variogram_kernel(MaternVariogram(psill=PSILL, range=RANGE_KM,
                                              nu=0.5), distance="haversine")
    glat_t = torch.as_tensor(glat, device=dev)
    glon_t = torch.as_tensor(glon, device=dev)

    def krige(dtype):
        return kriging_from_kernel(
            kernel, glat_t.to(dtype), glon_t.to(dtype), u, means.to(dtype),
            error_cov=Eg[dtype], variance=PSILL, method="ordinary",
            n_blocks=16)

    COUNTS["k1.launches"] = 0
    res32, krige_s = timed_s(lambda: krige(torch.float32))
    k1 = require_launches("K1 on the raw-observation kriging",
                          COUNTS["k1.launches"])
    errs = check_kriging(res32, krige(torch.float64), PSILL,
                         "raw-observation kriging")
    phase(27, "raw_observations_1deg", raw_obs=RAW_OBS, boxes=int(u.numel()),
          counts=f"{int(counts.min())}..{int(counts.max())}",
          boxes_and_counts="exact", mean_max_rel=f"{mean_rel:.3e}",
          mean_rtol=RAW_MEAN_RTOL,
          mean_max_rel_to_the_mean=(
              f"{np.max(mean_gap / np.abs(oracle_mean)):.3e}"),
          records=len(records),
          k1_launches=k1, tol=KRIGING_TOL,
          **{f"f32_vs_f64_{k}": f"{v:.3e}" for k, v in errs.items()},
          wewt_f32_vs_f64=f"{wewt_err:.3e}",
          wewt_f64_vs_numpy=f"{wewt_host_err:.3e}",
          generate_s=f"{gen_s:.4f}", ingest_first_s=f"{first_s:.4f}",
          ingest_s=f"{ingest_s:.4f}",
          ingest_mobs_per_s=f"{RAW_OBS / ingest_s / 1e6:.2f}",
          numpy_oracle_s=f"{oracle_s:.4f}",
          error_components_host_s=f"{host_s:.4f}",
          wewt_f32_ms=f"{wewt_ms:.4f}", kriging_f32_s=f"{krige_s:.4f}",
          netcdf_roundtrip="CPU tests only (no h5py on the card's machine)")
    return k1


def host_side_paths(dev):
    """Phases 25-27; returns K1's launches on the months scan and the
    raw-observation kriging, and K2's and K5's on the workflow."""
    k2, k5 = phase25_hadsst_workflow(dev)
    k1 = phase26_esa_months_scan(dev)
    k1 += phase27_raw_observations(dev)
    return k1, k2, k5


# ---------------------------------------------------------------------------
# phase 28: the sharded paths (parallel/) on four slots of the card
# ---------------------------------------------------------------------------
def timed(fn):
    """(fn(), seconds) on the host's clock around synchronisation."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def collective_mb(path, n_dev=SHARD_SLOTS, itemsize=4, **shape):
    """MB that would cross between slots on distinct cards in one call
    of a sharded path, counted from the shapes (on one card nothing
    moves): "kriging" (the factored system broadcast: n^2 + 4n values,
    the grid slices out and the three outputs back), "stream" (per
    application of k columns: x scattered, the ring's n_dev - 1 steps of
    every shard's packed points and x, the result gathered), "cholesky"
    (the diagonal factors broadcast and the panel pieces moved to the
    slots that update against them)."""
    if path == "kriging":
        n, m = shape["n"], shape["m"]
        values = (n_dev - 1) * (n * n + 4 * n) + (n_dev - 1) / n_dev * m * 5
    elif path == "stream":
        n, k = shape["n"], shape["k"]
        values = (n_dev - 1) * n * (16 + k) + 2 * (n_dev - 1) / n_dev * n * k
    else:
        n, blocks = shape["n"], shape["blocks"]
        nb, rows = n // blocks, n // n_dev
        values = 0
        for j in range(blocks - 1):
            c1 = (j + 1) * nb
            values += (n_dev - 1) * nb * nb
            below = [max(0, (t + 1) * rows - max(c1, t * rows))
                     for t in range(n_dev)]
            values += sum(below[t] * nb for s in range(n_dev) if below[s]
                          for t in range(s) if below[t])
    return values * itemsize / 1e6


def phase28a_kriging(mesh, glat, glon, obs):
    """``sharded_kriging_from_kernel`` at 64,800 x 5,000 (phase 4's
    kernel and observations) against ``kriging_from_kernel`` and against
    its own f64 run; returns K1's launches."""
    from glomargridding_tpu_torch import (
        MaternVariogram,
        kriging_from_kernel,
        variogram_kernel,
    )
    from glomargridding_tpu_torch.models.kernel_kriging import KrigingResult
    from glomargridding_tpu_torch.parallel import sharded_kriging_from_kernel

    idx, y, err = obs
    dev = y.device
    kernel = variogram_kernel(MaternVariogram(psill=PSILL, range=RANGE_KM,
                                              nu=0.5), distance="haversine")
    lats = torch.as_tensor(glat, device=dev)
    lons = torch.as_tensor(glon, device=dev)

    def sharded(dtype=torch.float32):
        out = sharded_kriging_from_kernel(
            mesh, kernel, lats.to(dtype), lons.to(dtype), idx, y.to(dtype),
            err.to(dtype), variance=PSILL)
        field, unc2, cmask = (o.gather() for o in out)
        return KrigingResult(field, torch.sqrt(torch.clamp(unc2, min=0.0)),
                             cmask)

    def single(e=err):
        return kriging_from_kernel(kernel, lats, lons, idx, y, e,
                                   variance=PSILL)

    COUNTS["k1.launches"] = 0
    got = sharded()
    sync()
    k1 = require_launches("K1 (sharded kriging)",
                          COUNTS["k1.launches"])
    ref = single()
    errs = kriging_errs(got, ref, PSILL ** 0.5)
    f64 = sharded(torch.float64)
    errs_f64 = check_kriging(got, f64, PSILL, "sharded kriging")
    control = single(1.1 * err)
    fault = max(kriging_errs(control, ref, PSILL ** 0.5).values())
    fault_f64 = max(kriging_errs(control, f64, PSILL ** 0.5).values())
    walls = {"sharded_s": wall_median_s(sharded),
             "single_s": wall_median_s(single)}
    phase(28, "a_sharded_kriging_64800x5000", slots=SHARD_SLOTS,
          k1_launches=k1, tol=SHARD_TOL,
          **{f"vs_single_{k}": f"{v:.3e}" for k, v in errs.items()},
          f64_tol=KRIGING_TOL,
          **{f"vs_f64_{k}": f"{v:.3e}" for k, v in errs_f64.items()},
          control_error_cov_x1_1=f"{fault:.3e}",
          control_vs_f64=f"{fault_f64:.3e}", repeats=REPEATS,
          moved_mb_on_4_cards=(
              f"{collective_mb('kriging', n=idx.numel(), m=glat.size):.1f}"),
          **{k: f"{v:.4f}" for k, v in walls.items()})
    for k, v in errs.items():
        check(f"sharded kriging vs single {k}", v, SHARD_TOL)
    if not (fault > SHARD_TOL and fault_f64 > KRIGING_TOL):
        raise AssertionError("the sharded kriging bounds pass the control")
    return k1


def phase28b_covariance(mesh, glat, glon):
    """``sharded_ellipse_covariance`` at 64,800 (nu = 1.5, phase 9's
    fields) against K2's matrix, slot by slot; returns K4's launches."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te
    from glomargridding_tpu_torch.parallel import sharded_ellipse_covariance

    dev = mesh.devices[0, 0]
    fields = realistic_ellipse_params(glat, glon)
    reset_ellipse_counts()
    cov, sharded_s = timed(lambda: sharded_ellipse_covariance(
        mesh, *fields, glat, glon, v=NU_NS))
    k4 = require_launches("K4 (sharded row blocks)", COUNTS["k4.launches"])
    shapes = {tuple(p.shape) for p in cov.parts}
    P = te.pack_points(*ellipse_args(glat, glon, fields, torch.float32, dev))
    K2, k2_s = timed(lambda: te.ellipse_sym(P, NU_NS))
    scale = torch.max(torch.abs(K2)).item()
    rows = P.shape[0] // SHARD_SLOTS
    worst, equal = 0.0, True
    for s in range(SHARD_SLOTS):
        diff = torch.max(torch.abs(
            cov.parts[s] - K2[s * rows:(s + 1) * rows])).item()
        equal &= diff == 0.0
        worst = max(worst, diff / scale)
        cov.parts[s] = None  # free the slot's block as it goes
    control = te.ellipse_tile(P[:rows], P, 2.5)
    control.diagonal().add_(P[:rows, 6] ** 2)
    fault = torch.max(torch.abs(control - K2[:rows])).item() / scale
    del control, K2, cov
    phase(28, "b_sharded_covariance_64800", slots=SHARD_SLOTS, nu=NU_NS,
          k4_launches=k4, blocks="|".join(f"{a}x{b}" for a, b in shapes),
          gb=f"{P.shape[0] ** 2 * 4 / 1e9:.1f}", vs_k2=f"{worst:.3e}",
          bitwise=equal, tol=SHARD_COV_TOL, control_nu_2_5=f"{fault:.3e}",
          sharded_s=f"{sharded_s:.4f}", k2_single_s=f"{k2_s:.4f}")
    check("sharded covariance vs K2", worst, SHARD_COV_TOL)
    if not fault > SHARD_COV_TOL:
        raise AssertionError("the covariance bound passes nu = 2.5")
    return k4


def phase28c_stream(mesh):
    """The ring-SUMMA stream operator at 259,200 cells (3,000 km cutoff,
    phase 11's fields) at 8 and 1,024 columns against the single-device
    stream; returns (K3, K4) launches."""
    from glomargridding_tpu_torch import ellipse_covariance_operator
    from glomargridding_tpu_torch.parallel import (
        sharded_ellipse_stream_operator,
    )

    dev = mesh.devices[0, 0]
    q_lat, q_lon = grid_linspace(*STREAM_GRID)
    fields = realistic_ellipse_params(q_lat, q_lon)
    n = q_lat.size
    rng = np.random.default_rng(5)
    x8 = torch.as_tensor(rng.normal(size=(n, 8)).astype(np.float32),
                         device=dev)
    x1k = torch.as_tensor(
        rng.normal(size=(n, WIDE_COLS)).astype(np.float32), device=dev)
    reset_ellipse_counts()
    mv, _, trace = sharded_ellipse_stream_operator(
        mesh, *fields, q_lat, q_lon, v=NU_NS, max_dist=MAX_DIST_KM)
    y8 = mv(x8)
    y1k = mv(x1k)
    sync()
    k3 = require_launches("K3 (sharded narrow stream)",
                          COUNTS["k3.launches"])
    k4 = require_launches("K4 (sharded wide stream)",
                          COUNTS["k4.launches"])
    args = ellipse_args(q_lat, q_lon, fields, torch.float32, dev)
    single, _, _ = ellipse_covariance_operator(
        *args, v=NU_NS, store="stream", max_dist=MAX_DIST_KM)
    errs = {"y8": max_rel(y8, single(x8)), "y1024": max_rel(y1k, single(x1k))}
    del y1k
    wrong, _, _ = ellipse_covariance_operator(
        *args, v=NU_NS, store="stream", max_dist=0.9 * MAX_DIST_KM)
    fault = max_rel(wrong(x8), y8)
    times = {"sharded_8_ms": cuda_time_ms(lambda: mv(x8), iters=5),
             "single_8_ms": cuda_time_ms(lambda: single(x8), iters=5),
             "sharded_1024_ms": cuda_time_ms(lambda: mv(x1k), iters=2),
             "single_1024_ms": cuda_time_ms(lambda: single(x1k), iters=2)}
    stats = mv.band_stats
    phase(28, "c_sharded_stream_259200", slots=SHARD_SLOTS,
          max_dist_km=MAX_DIST_KM, k3_launches=k3, k4_launches=k4,
          shard_pairs=stats["pairs"], wide_pairs=stats["wide_pairs"],
          fused_pairs=stats["fused_pairs"], tol=STREAM_ORDER_TOL,
          **{f"vs_single_{k}": f"{v:.3e}" for k, v in errs.items()},
          control_cutoff_0_9=f"{fault:.3e}", trace=f"{trace:.6g}",
          moved_mb_on_4_cards_8_1024="|".join(
              f"{collective_mb('stream', n=n, k=k):.1f}"
              for k in (8, WIDE_COLS)),
          **{k: f"{v:.3f}" for k, v in times.items()})
    for k, v in errs.items():
        check(f"sharded stream vs single {k}", v, STREAM_ORDER_TOL)
    if not fault > STREAM_ORDER_TOL:
        raise AssertionError("the stream bound passes a 2,700 km cutoff")
    return k3, k4


def dense_sub(psd, cells, dtype=torch.float32):
    """The densified factored covariance on the cells `cells`."""
    V = psd.vectors[cells].to(dtype)
    C = (V * psd.gains.to(dtype)[None, :]) @ V.T
    C.diagonal().add_(psd.floor[cells].to(dtype))
    return C


def slot_order_draw(dev, slots, seed=0):
    """The whole-tensor ``draw`` of a row-sharded solve's draws from a
    generator seeded `seed` on `dev` (the solver's default): each block's
    slots' rows drawn one after another (``ops.eigsh._normal``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, dtype):
        rows = (shape[0] // slots, *shape[1:])
        return torch.cat([torch.randn(rows, dtype=dtype, device=dev,
                                      generator=gen) for _ in range(slots)])

    return draw


def phase28d_clip(mesh, glat, glon, psd13):
    """The explained-variance clip of the sharded stream at 64,800 (no
    cutoff, phase 13's arguments, the eigensolver's blocks row-sharded)
    against the same clip of the single-device stream from the same
    start blocks, densified on a 16,384-cell sub-block and by trace;
    returns (K3, K4) launches and the sub-block's cells."""
    from glomargridding_tpu_torch import (
        ellipse_covariance_operator,
        explained_variance_clip_lowrank,
    )
    from glomargridding_tpu_torch.ops.sampling import Matvec
    from glomargridding_tpu_torch.parallel import (
        sharded_ellipse_stream_operator,
    )
    from glomargridding_tpu_torch.parallel.ellipse import (
        clip_memory_analysis,
    )

    dev = mesh.devices[0, 0]
    fields = realistic_ellipse_params(glat, glon)
    mv, n, trace = sharded_ellipse_stream_operator(mesh, *fields, glat, glon,
                                                   v=NU_NS)
    if len(mv.row_devices) != SHARD_SLOTS:
        raise AssertionError("the sharded stream names no row slots")

    def clip(op, target=CLIP_TARGET, draw=None):
        return explained_variance_clip_lowrank(
            op, n=n, trace=trace, target_variance_fraction=target,
            draw=draw, **CLIP_KW)

    reset_ellipse_counts()
    psd, sharded_s = timed(lambda: clip(mv))
    k3, k4 = COUNTS["k3.launches"], COUNTS["k4.launches"]
    require_launches("K3 or K4 (sharded clip)", k3 + k4)
    single, _, _ = ellipse_covariance_operator(
        *ellipse_args(glat, glon, fields, torch.float32, dev), v=NU_NS,
        store="stream")
    # the whole-tensor forms start from the sharded form's normals
    ref, single_s = timed(lambda: clip(single, draw=slot_order_draw(
        dev, SHARD_SLOTS)))
    cells = torch.as_tensor(np.unique(np.linspace(
        0, n - 1, SHARD_LINALG_N).astype(np.int64)), device=dev)
    want = dense_sub(ref, cells)
    scale = torch.max(torch.abs(want)).item()
    err = max_rel(dense_sub(psd, cells), want, scale)
    vs13 = max_rel(dense_sub(psd13, cells), want, scale)
    trace_rel = abs(psd.trace() - ref.trace()) / ref.trace()
    trace13 = abs(psd.trace() - psd13.trace()) / psd13.trace()
    wrong = clip(mv, CLIP_WRONG_TARGET)
    fault = max_rel(dense_sub(wrong, cells), want, scale)
    del wrong
    # the same operator with its blocks whole on the first slot (PR 9's
    # form), and the bytes each slot holds of the row-sharded blocks
    whole, whole_s = timed(lambda: clip(Matvec(mv.fn), draw=slot_order_draw(
        dev, SHARD_SLOTS)))
    whole_err = max_rel(dense_sub(whole, cells), want, scale)
    del whole
    width = CLIP_KW["k0"] + 8
    per_slot, blocks_whole, small = clip_memory_analysis(n, width,
                                                         SHARD_SLOTS)
    phase(28, "d_sharded_clip_64800", slots=SHARD_SLOTS, target=CLIP_TARGET,
          rank=psd.rank, single_rank=ref.rank, k3_launches=k3,
          k4_launches=k4, sub_cells=int(cells.numel()),
          vs_single_stream=f"{err:.3e}", tol=SUB_TOL,
          vs_phase13_bf16_factors=f"{vs13:.3e}",
          trace_vs_single=f"{trace_rel:.3e}",
          trace_vs_phase13=f"{trace13:.3e}", trace_tol=TRACE_TOL,
          control_target_0_8=f"{fault:.3e}",
          row_sharded_blocks_s=f"{sharded_s:.3f}",
          whole_blocks_s=f"{whole_s:.3f}", single_s=f"{single_s:.3f}",
          whole_blocks_vs_single=f"{whole_err:.3e}", width=width,
          block_gb_per_slot=f"{per_slot / 1e9:.3f}",
          block_gb_whole=f"{blocks_whole / 1e9:.3f}",
          small_gb=f"{small / 1e9:.4f}")
    check("sharded clip vs single-device stream clip", err, SUB_TOL)
    check("whole-block sharded clip vs single-device stream clip",
          whole_err, SUB_TOL)
    check("sharded clip trace", trace_rel, TRACE_TOL)
    check("sharded clip trace vs phase 13", trace13, TRACE_TOL)
    if not fault > SUB_TOL:
        raise AssertionError("the clip bound passes the 0.80 target")
    return k3, k4, cells


def phase28e_ensemble(mesh, psd, obs):
    """``ensemble_kriging_step`` at 64,800 on the densified repaired
    covariance, 100 members, against ``batched_ensemble_step`` on the
    same normals, in f32 and in f64."""
    from glomargridding_tpu_torch import LowRankPSD, batched_ensemble_step
    from glomargridding_tpu_torch.parallel import ensemble_kriging_step
    from glomargridding_tpu_torch.parallel.linalg import resolve_blocks_padded

    idx, y, err = obs
    dev = y.device
    n, m = psd.n, idx.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    z_state = torch.randn((N_MEMBERS, n), generator=gen, device=dev)
    z_obs = torch.randn((N_MEMBERS, m), generator=gen, device=dev)
    out, walls = {}, {}
    for dtype in (torch.float32, torch.float64):
        f = LowRankPSD(psd.vectors.to(dtype), psd.gains.to(dtype),
                       psd.floor.to(dtype))
        C = f.to_dense()
        del f
        noise = (z_state.to(dtype), z_obs.to(dtype))
        E, yy = err.to(dtype), y.to(dtype)
        torch.cuda.reset_peak_memory_stats()
        (members, field, _), walls[f"sharded_{dtype}"] = timed(
            lambda: ensemble_kriging_step(mesh, C, E, idx, yy, N_MEMBERS,
                                          noise=noise))
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[dtype, "sharded"] = (members.gather(), field.gather())
        blocks = {tuple(p.shape) for p in members.parts}
        del members, field
        torch.cuda.empty_cache()
        if dtype == torch.float32:
            control = ensemble_kriging_step(mesh, C, 1.1 * E, idx, yy,
                                            N_MEMBERS, noise=noise)
            out["control"] = control[0].gather()
            del control
        (members, field), walls[f"single_{dtype}"] = timed(
            lambda: batched_ensemble_step(C, E, idx, yy, N_MEMBERS,
                                          noise=noise))
        out[dtype, "single"] = (members, field)
        del C, members, field
        torch.cuda.empty_cache()

    def errs(a, b):
        return (max_rel(a[0], b[0], torch.max(torch.abs(b[0])).item()),
                max_rel(a[1], b[1]))

    f32 = errs(out[torch.float32, "sharded"], out[torch.float32, "single"])
    f64 = errs(out[torch.float64, "sharded"], out[torch.float64, "single"])
    single64 = out[torch.float64, "single"]
    fault = errs((out["control"], single64[1]), single64)[0]
    fault64 = errs(out[torch.float32, "sharded"], single64)
    phase(28, "e_sharded_ensemble_64800", slots=SHARD_SLOTS,
          members=N_MEMBERS, blocks="|".join(f"{a}x{b}" for a, b in blocks),
          f32_members=f"{f32[0]:.3e}", f32_field=f"{f32[1]:.3e}",
          tol=MEMBERS_TOL, f64_members=f"{f64[0]:.3e}",
          f64_field=f"{f64[1]:.3e}", f64_tol=SHARD_F64_TOL,
          control_error_cov_x1_1=f"{fault:.3e}",
          control_f32_vs_f64=f"{max(fault64):.3e}",
          f64_peak_gb=f"{peak:.3f}",
          cholesky_moved_mb_f32_on_4_cards=f"{collective_mb(
              'cholesky', n=n, blocks=resolve_blocks_padded(
                  n, SHARD_SLOTS, None)[0]):.1f}",
          **{f"{k.replace('torch.float', 'f')}_s": f"{v:.3f}"
             for k, v in walls.items()})
    for label, v in (("f32 members", f32[0]), ("f32 field", f32[1])):
        check(f"sharded ensemble {label}", v, MEMBERS_TOL)
    for label, v in (("f64 members", f64[0]), ("f64 field", f64[1])):
        check(f"sharded ensemble {label}", v, SHARD_F64_TOL)
    if not (fault > MEMBERS_TOL and max(fault64) > SHARD_F64_TOL):
        raise AssertionError("the ensemble bounds pass their controls")


def phase28f_lowrank(mesh22, psd, obs):
    """The sharded factored kriging and ensemble on phase 14's padded
    factors (2 x 2 mesh) against the single-device path on the same
    normals."""
    from glomargridding_tpu_torch import lowrank_ensemble_step, lowrank_kriging
    from glomargridding_tpu_torch.parallel import (
        sharded_lowrank_ensemble_step,
        sharded_lowrank_kriging,
    )

    idx, y, err = obs
    dev = y.device
    e = torch.diagonal(err).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    noise = tuple(torch.randn(shape, generator=gen, device=dev) for shape in (
        (psd.n, N_MEMBERS), (psd.rank, N_MEMBERS), (idx.numel(), N_MEMBERS)))
    sd_scale = float(torch.sqrt(psd.diagonal().max()))

    def sharded():
        return sharded_lowrank_ensemble_step(mesh22, psd, idx, y, e,
                                             n_members=N_MEMBERS, noise=noise)

    def single():
        return lowrank_ensemble_step(psd, idx, y, e, n_members=N_MEMBERS,
                                     noise=noise)

    res = [o.gather() for o in sharded_lowrank_kriging(mesh22, psd, idx, y,
                                                        e)]
    ref = lowrank_kriging(psd, idx, y, e)
    (res_e, members), sharded_s = timed(sharded)
    (ref_e, members_ref), single_s = timed(single)
    errs = {f"kriging_{k}": v
            for k, v in kriging_errs(res, ref, sd_scale).items()}
    errs.update({f"ensemble_{k}": v for k, v in kriging_errs(
        [o.gather() for o in res_e], ref_e, sd_scale).items()})
    errs["ensemble_members"] = max_rel(members.gather(), members_ref)
    blocks = {tuple(p.shape) for p in members.parts}
    fault = max(kriging_errs(lowrank_kriging(psd, idx, y, 1.1 * e), ref,
                             sd_scale).values())
    phase(28, "f_sharded_lowrank_64800", mesh="2x2", rank=psd.rank,
          members=N_MEMBERS, blocks="|".join(f"{a}x{b}" for a, b in blocks),
          tol=SHARD_TOL, **{k: f"{v:.3e}" for k, v in errs.items()},
          control_error_cov_x1_1=f"{fault:.3e}",
          sharded_ensemble_s=f"{sharded_s:.4f}",
          single_ensemble_s=f"{single_s:.4f}")
    for k, v in errs.items():
        check(f"sharded lowrank {k}", v, SHARD_TOL)
    if not fault > SHARD_TOL:
        raise AssertionError("the lowrank bound passes the control")


def phase28g_linalg(mesh, psd, cells):
    """The blocked Cholesky, the triangular solve, whitening and the
    Gaussian score at 16,384 in f64 against torch.linalg, on the
    repaired covariance's sub-block."""
    from glomargridding_tpu_torch.parallel import (
        sharded_cholesky,
        sharded_mvn_logpdf,
        sharded_triangular_solve,
        sharded_whiten,
    )

    dev = mesh.devices[0, 0]
    C = dense_sub(psd, cells, torch.float64)
    n = C.shape[0]
    B = torch.randn((n, 8), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    L, sharded_s = timed(lambda: sharded_cholesky(mesh, C))
    L_ref, single_s = timed(lambda: torch.linalg.cholesky(C))
    X_ref = torch.linalg.solve_triangular(L_ref, B, upper=False)
    logp = (-0.5 * torch.sum(X_ref * X_ref, dim=0)
            - torch.sum(torch.log(torch.diagonal(L_ref)))
            - 0.5 * n * float(np.log(2.0 * np.pi)))
    errs = {
        "cholesky": max_rel(L.gather(), L_ref),
        "triangular_solve": max_rel(sharded_triangular_solve(mesh, L, B),
                                    X_ref),
        "whiten": max_rel(sharded_whiten(mesh, L, B), X_ref),
        "mvn_logpdf": max_rel(sharded_mvn_logpdf(mesh, L, B), logp),
    }
    fault = max_rel(torch.linalg.cholesky(C.float()), L_ref)
    del L, L_ref, C
    phase(28, "g_sharded_linalg_16384_f64", slots=SHARD_SLOTS,
          tol=SHARD_LINALG_TOL, **{k: f"{v:.3e}" for k, v in errs.items()},
          control_f32_cholesky=f"{fault:.3e}",
          sharded_cholesky_s=f"{sharded_s:.4f}",
          torch_cholesky_s=f"{single_s:.4f}")
    for k, v in errs.items():
        check(f"sharded {k}", v, SHARD_LINALG_TOL)
    if not fault > SHARD_LINALG_TOL:
        raise AssertionError("the linalg bound passes an f32 factor")


def sharded_fits(builder, chunks, slots):
    """Phase 28h's fits of the chunks, sharded over `slots` and on one
    slot: f64 Nelder-Mead, f32 Levenberg-Marquardt, and the nu = 0.5
    control (sharded only); ({(tag, where): fit_lanes}, walls)."""
    from glomargridding_tpu_torch import EllipseModel

    model = EllipseModel(**FIT_MODEL)
    fits, walls = {}, {}
    for tag, dtype, lane, tol, fit_model in (
            ("f64_nm", np.float64, "nm", FIT_KW["tol"], model),
            ("f32_lm", np.float32, "lm", LM_TOL, model),
            ("f32_lm_nu_0_5", np.float32, "lm", LM_TOL,
             EllipseModel(**{**FIT_MODEL, "v": 0.5}))):
        b = builder(dtype)
        for where in (("sharded", slots), ("single", None)):
            if tag.endswith("nu_0_5") and where[0] == "single":
                continue
            fitter = subset_fitter(b, fit_model, lane, tol, where[1])
            fits[tag, where[0]], walls[f"{tag}_{where[0]}_s"] = timed(
                lambda: fit_lanes(fitter, chunks))
        del b
    return fits, walls


def phase28h_fit(mesh, glat, glon, psd):
    """``compute_params(mesh=...)``'s split of a chunk's lanes over the
    slots, on phase 16's 4,096-lane subset and phase 16's cube, against
    the unsharded fit of the same lanes: Nelder-Mead in f64 lane for
    lane, Levenberg-Marquardt in f32 by share."""
    from glomargridding_tpu_torch import Coordinates, EllipseBuilder

    dev = psd.vectors.device
    lat_axis, lon_axis = np.unique(glat), np.unique(glon)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cube = psd.draw(T_TRAIN, generator=gen).contiguous().reshape(
        T_TRAIN, lat_axis.size, lon_axis.size)

    def builder(dtype):
        return EllipseBuilder(
            cube.to(torch.float64 if dtype == np.float64 else torch.float32),
            Coordinates({
                "time": np.arange(T_TRAIN),
                "latitude": lat_axis.astype(dtype),
                "longitude": lon_axis.astype(dtype)}), cor_mode="lazy")

    chunks = [np.arange(s, s + FIT_KW["chunk_size"]) for s in SUBSET_STARTS]
    COUNTS["k5.launches"] = 0
    fits, walls = sharded_fits(builder, chunks, mesh.axis_devices("grid"))
    k5 = require_launches("K5 (the sharded simplex)", COUNTS["k5.launches"])
    (_, pm_s, qc_s, _), (_, pm_1, qc_1, _) = (fits["f64_nm", k]
                                              for k in ("sharded", "single"))
    both = (qc_s == 0) & (qc_1 == 0)
    dev64 = fit_deviation(pm_s, pm_1, both)
    f64_worst = max(float(v.max()) for v in dev64.values())
    lm_s, lm_1 = fits["f32_lm", "sharded"], fits["f32_lm", "single"]
    lm_keep = (lm_s[2] == 0) & (lm_1[2] == 0)
    dev32 = fit_deviation(lm_s[1], lm_1[1], lm_keep)
    ellipse = ("Lx_rel", "Ly_rel", "theta_abs")
    share = share_within(dev32, ellipse)
    wrong = fits["f32_lm_nu_0_5", "sharded"]
    fault = share_within(fit_deviation(wrong[1], lm_1[1],
                                       (wrong[2] == 0) & (lm_1[2] == 0)),
                         ellipse)
    fault64 = max(float(v.max()) for v in fit_deviation(
        lm_s[1], pm_1, lm_keep & (qc_1 == 0)).values())
    phase(28, "h_sharded_fit_subset", slots=SHARD_SLOTS,
          lanes=sum(c.size for c in chunks), qc_equal_f64=bool(
              np.array_equal(qc_s, qc_1)), qc0_in_both=int(both.sum()),
          f64_worst_rel=f"{f64_worst:.3e}", f64_rtol=SHARD_FIT_F64_RTOL,
          lm_f32_share=f"{share:.4f}", share_bound=FIT_SHARE_LM,
          **{f"lm_f32_{k}_max": f"{float(v.max()):.3e}"
             for k, v in dev32.items()},
          control_nu_0_5_share=f"{fault:.4f}",
          control_f32_vs_f64_worst=f"{fault64:.3e}", k5_launches=k5,
          **{k: f"{v:.3f}" for k, v in walls.items()})
    check("sharded f64 fit vs single", f64_worst, SHARD_FIT_F64_RTOL)
    if not share >= FIT_SHARE_LM:
        raise AssertionError(f"sharded f32 LM: {share:.4f} of lanes within "
                             f"the bounds, under {FIT_SHARE_LM}")
    if not (fault < FIT_SHARE_LM and fault64 > SHARD_FIT_F64_RTOL):
        raise AssertionError("the fit bounds pass their controls")
    return k5


def sharded_paths(dev, glat, glon, obs, psd):
    """Phase 28, the sharded paths on four slots of the card; returns the
    launches (K1, K3, K4, K5) of the sharded path."""
    from glomargridding_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_grid=SHARD_SLOTS, n_ens=1, devices=[dev] * SHARD_SLOTS)
    mesh22 = make_mesh(n_grid=2, n_ens=2, devices=[dev] * SHARD_SLOTS)
    torch.cuda.empty_cache()  # phase 28e's f64 step peaks near 75 GB
    t0 = time.perf_counter()
    k1 = phase28a_kriging(mesh, glat, glon, obs)
    k4 = phase28b_covariance(mesh, glat, glon)
    k3_c, k4_c = phase28c_stream(mesh)
    k3_d, k4_d, cells = phase28d_clip(mesh, glat, glon, psd)
    phase28e_ensemble(mesh, psd, obs)
    phase28f_lowrank(mesh22, psd, obs)
    phase28g_linalg(mesh, psd, cells)
    k5 = phase28h_fit(mesh, glat, glon, psd)
    phase(28, "sharded_paths", seconds=f"{time.perf_counter() - t0:.1f}")
    return k1, k3_c + k3_d, k4 + k4_c + k4_d, k5


# ---------------------------------------------------------------------------
# phases 29-30: the examples' twins at full size
# ---------------------------------------------------------------------------
# phase 29, examples/torch_nonstationary_quarter_degree.py with nothing cut
# the f32 cube against the f64 cube drawn from the same normals, over
# max |cube|: f32 rounding of the spherical-harmonic synthesis
QD_CUBE_TOL = 1e-3
# lazy correlation rows, f32 against the same rows in f64 from the cube
# (absolute: correlations); the control leaves the samples uncentred
QD_ROWS = 8
QD_ROW_TOL = 1e-5
# fit chunk sizes timed on two chunks each (the twin's CHUNK_SIZE is the
# fastest)
QD_CHUNK_SIZES = (1024, 2048, 4096)
# the share of converged fits (QC != 9) of the whole grid: the JAX run
# converged 259,104 of 259,200 (its count of fits with QC != 9). QC 0
# alone is printed: the simplex ends ~3% of the lanes, most of them
# polar, on a bound (QC 1; phase 16's polar chunk). The control refits
# the equatorial chunk with a tolerance f32 cannot meet
QD_CONVERGED_SHARE = 0.99
QD_CONTROL_TOL = 1e-12
# a resumed fit off a completed checkpoint: no chunk solved
QD_RESUME_S = 5.0
# the stream's K3 against its wide path, and 1,024 of its rows against
# an f64 slab of the plain twin (the cutoff decided on the f32 points, as
# the kernels decide it), over max |C|; the control is a 2,700 km cutoff
QD_STREAM_TOL = 1e-5
QD_SLAB_ROWS = 1024
QD_SLAB_TOL = 1e-5
QD_CUTOFF_CONTROL_KM = 2700.0
# two clips from different start blocks, densified on a sub-block, over
# max |C|; the control clips at target 0.80 (0.112). The example's clip
# (n_iter 3, a start block 1,032 wide for a retained rank of 975) leaves
# the Ritz vectors at its cut converged to the solver's f32 residual gate
# and no further: two starts agree to 5.8e-3 (NVIDIA H100 80GB HBM3,
# 700 W), where phase 13's clip at 64,800 meets the full spectrum to
# 6.4e-4
QD_SUB_CELLS = 16384
QD_CLIP_TOL = 1e-2
# f32 kriging off the factors against the same call on f64 factors; the
# consistency control krige the truth with the covariance x 1.5 (an
# error variance x 1.5 moves the three together and does not break it)
QD_FACTOR_TOL = KRIGING_TOL
QD_COVARIANCE_CONTROL = 1.5

# phase 30, the three 1-degree twins
# K1's tiles + nugget against kernel_block's plain torch form with the
# full arcsin (examples/torch_large_ensemble_65k.NUGGET_TOL, relative to
# the variance); members f32 against f64 over max |member|
LE_MEMBERS_TOL = 1e-3
LE_ERROR_CONTROL = 1.1
# K4's 40,000-point build against the plain twin in f64 on a block, over
# max |C|; the control is the twin at nu = 1.5
EC_BLOCK = 2048
EC_TOL = 1e-5


def qd_chunk_starts(n, chunk, lat_axis):
    """Chunk-aligned starts of an equatorial chunk and of the chunk holding
    85 N (the polar lanes)."""
    n_lon = n // lat_axis.size
    polar_cell = int(np.searchsorted(lat_axis, 85.0)) * n_lon
    polar = polar_cell // chunk * chunk
    if polar + chunk > n:
        polar -= chunk
    return ((n // 2) // chunk * chunk, polar)


def qd_cube_and_rows(tq, dev, gen):
    """Phase 29 a-b: the sampler build split, the f32 and f64 cubes from
    the same normals, the lazy correlation and its rows."""
    from glomargridding_tpu_torch.models.ellipse import estimate
    from glomargridding_tpu_torch.ops import sphere

    lat, lon, glat, glon = tq.axes()
    r = tq.TRAIN_RANGE_KM / 3.0 / tq.EARTH_KM

    def corr(ang):
        return np.exp(-ang / r)

    split = {}
    _, split["angular_power_s"] = timed_s(
        lambda: sphere.angular_power(corr, tq.L_MAX, 4096))
    x = torch.as_tensor(np.sin(np.radians(lat)), device=dev)
    _, split["device_table_s"] = timed_s(
        lambda: sphere._legendre_table_device(x, tq.L_MAX))
    _, split["dft_tables_s"] = timed_s(
        lambda: sphere.dft_tables(tq.L_MAX, lon))
    sampler, split["build_s"] = timed_s(
        lambda: tq.training_sampler(lat, lon, torch.float32, dev))
    noise = tq.cube_noise(sampler, gen)
    cube, draw_s = timed_s(lambda: tq.training_cube(sampler, noise))
    sampler64 = tq.training_sampler(lat, lon, torch.float64, dev)
    cube64 = tq.training_cube(sampler64, noise)
    cube_err = max_rel(cube, cube64)
    control = tq.training_cube(sampler64, noise[:2] + [
        torch.zeros_like(noise[2])])
    cube_control = max_rel(control, cube64)
    del control, sampler64, noise, cube64
    n = glat.size
    if cube.shape != (tq.T_TRAIN, tq.M_LAT, tq.M_LON) or not bool(
            torch.isfinite(cube).all()):
        raise AssertionError("the training cube is malformed")

    builder, cor_s = timed_s(lambda: tq.correlation(cube, lat, lon))
    lazy = isinstance(builder.cor, estimate._LazyCorrelation)
    if not lazy:
        raise AssertionError("cor_mode='auto' kept the dense correlation")
    rows = np.linspace(0, n - 1, QD_ROWS).astype(np.int64)
    got = torch.stack([builder.cor.row(int(i)) for i in rows])
    x64 = cube.double().reshape(tq.T_TRAIN, n)

    def rows_of(x):
        xn = estimate._normalised_samples(x)
        out = xn[:, torch.as_tensor(rows, device=dev)].T @ xn
        out[torch.arange(rows.size), torch.as_tensor(rows, device=dev)] = 1.0
        return out

    want = rows_of(x64 - x64.mean(dim=0, keepdim=True))
    row_err = torch.max(torch.abs(got.double() - want)).item()
    row_control = torch.max(torch.abs(rows_of(x64).float().double()
                                      - want)).item()
    del x64, want, got
    phase(29, "a_training_cube", T=tq.T_TRAIN, cells=n, l_max=tq.L_MAX,
          nugget=tq.NUGGET, **{k: f"{v:.3f}" for k, v in split.items()},
          draw_s=f"{draw_s:.4f}", f32_vs_f64=f"{cube_err:.3e}",
          tol=QD_CUBE_TOL, control_no_nugget=f"{cube_control:.3e}")
    phase(29, "b_lazy_correlation", cor_mode="auto", lazy=lazy,
          dense_gb_avoided=f"{n * n * 4 / 1e9:.1f}",
          builder_s=f"{cor_s:.4f}", rows=rows.size,
          f32_vs_f64=f"{row_err:.3e}", tol=QD_ROW_TOL,
          control_uncentred=f"{row_control:.3e}")
    check("phase 29 cube f32 vs f64", cube_err, QD_CUBE_TOL)
    check("phase 29 lazy rows f32 vs f64", row_err, QD_ROW_TOL)
    if not cube_control > QD_CUBE_TOL or not row_control > QD_ROW_TOL:
        raise AssertionError("a phase 29 a-b bound passes its control")
    return cube, builder, (lat, lon, glat, glon)


def qd_chunk_times(tq, builder, model, lat_axis):
    """{chunk size: ms per lane} of the fit's chunk fitter, two chunks at
    each size (the build and the solve), and what ``_chunk_cap`` allows."""
    n = builder.small_covar_size
    cap, _ = builder._chunk_cap(n, builder._x_centered.element_size())
    out = {}
    for chunk in QD_CHUNK_SIZES:
        if chunk > cap:
            out[chunk] = None
            continue
        fitter = subset_fitter(builder, model, "nm", tq.FIT_KW["tol"],
                               fit_kw=tq.FIT_KW)
        starts = qd_chunk_starts(n, chunk, lat_axis)
        sync()
        t0 = time.perf_counter()
        for s0 in starts:
            fitter["fit"](np.arange(s0, s0 + chunk))
        sync()
        out[chunk] = 1e3 * (time.perf_counter() - t0) / (len(starts) * chunk)
    return out, cap


def fit_counts():
    """The counters a fit's K5 launches are held to."""
    return {k: COUNTS[k] for k in ("k5.launches", "nm.iterations",
                                   "nm.shrinks")}


def k5_on_every_call(label, before, solves):
    """(K5's launches, the objective calls) since `before`
    (``fit_counts()``) over `solves` Nelder-Mead solves, held equal: a
    solve's objective calls are its start, one a trip and one a shrink
    pass, and every one on the card runs on K5."""
    delta = {k: COUNTS[k] - v for k, v in before.items()}
    k5 = require_launches(f"K5 ({label})", delta["k5.launches"])
    calls = solves + delta["nm.iterations"] + delta["nm.shrinks"]
    if k5 != calls:
        raise AssertionError(f"{label}: {k5} K5 launches for {calls} "
                             "objective calls")
    return k5, calls


def qd_fit(tq, dev, builder, axes4):
    """Phase 29 c: the whole-grid fit through the twin, the held lanes,
    the checkpoint's resume."""
    import tempfile

    from glomargridding_tpu_torch import EllipseModel
    from glomargridding_tpu_torch.models.ellipse import estimate

    lat, _, glat, _ = axes4
    n = glat.size
    model = EllipseModel(**tq.FIT_MODEL)
    per_lane, cap = qd_chunk_times(tq, builder, model, lat)
    watch = {"build": Stopwatch(estimate._chunk_train_data),
             "solve": Stopwatch(estimate.batched_nelder_mead)}
    iterations = []

    def solve(*args, **kwargs):
        res = watch["solve"](*args, **kwargs)
        iterations.append(int(res.nit.max()))
        return res

    keep = estimate._chunk_train_data, estimate.batched_nelder_mead
    estimate._chunk_train_data, estimate.batched_nelder_mead = (
        watch["build"], solve)
    ckpt_dir = tempfile.mkdtemp(prefix="glomar_smoke_")
    ckpt = f"{ckpt_dir}/quarter_degree_mle.npz"
    try:
        torch.cuda.reset_peak_memory_stats()
        before = fit_counts()
        params, fit_s = timed_s(lambda: tq.fit_ellipses(builder,
                                                        checkpoint=ckpt))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        solved = watch["solve"].calls
        k5, calls = k5_on_every_call("the 0.5-degree fit", before, solved)
        resumed, resume_s = timed_s(lambda: tq.fit_ellipses(
            builder, checkpoint=ckpt))
        resume_solves = watch["solve"].calls - solved
    finally:
        estimate._chunk_train_data, estimate.batched_nelder_mead = keep
        for name in ("quarter_degree_mle.npz",
                     "quarter_degree_mle.npz.tmp.npz"):
            if os.path.exists(f"{ckpt_dir}/{name}"):
                os.remove(f"{ckpt_dir}/{name}")
        os.rmdir(ckpt_dir)
    names = ("Lx", "Ly", "theta", "standard_deviation", "qc_code")
    flat = {k: np.asarray(params[k].values, float).reshape(-1)
            for k in names}
    same = all(np.array_equal(flat[k], np.asarray(
        resumed[k].values, float).reshape(-1)) for k in names)
    qc = flat["qc_code"].astype(int)
    qc0_share = float(np.mean(qc == 0))
    converged = float(np.mean(qc != 9))
    chunk = tq.CHUNK_SIZE
    n_chunks = -(-n // chunk)
    solve_s = sum(dt for _, dt in watch["solve"].log[:solved])
    build_s = sum(dt for _, dt in watch["build"].log[:solved])
    codes, counts = np.unique(qc, return_counts=True)
    phase(29, "c_whole_grid_fit", lanes=n, nu=tq.FIT_MODEL["v"],
          chunk=chunk, chunks=n_chunks, cols=tq.FIT_KW["max_train_cols"],
          chunk_cap=cap,
          chunk_ms_per_lane="|".join(
              f"{c}:{'over_cap' if v is None else f'{v:.4f}'}"
              for c, v in per_lane.items()),
          fit_s=f"{fit_s:.3f}", chunk_build_s=f"{build_s:.3f}",
          chunk_solve_s=f"{solve_s:.3f}",
          loop_iterations=sum(iterations),
          ms_per_iteration=f"{1e3 * solve_s / max(sum(iterations), 1):.3f}",
          qc_counts="|".join(f"{c}:{k}" for c, k in zip(codes, counts)),
          qc0_share=f"{qc0_share:.5f}", converged_share=f"{converged:.5f}",
          converged_bound=QD_CONVERGED_SHARE,
          fit_peak_gb=f"{peak_gb:.3f}", resume_s=f"{resume_s:.3f}",
          resume_bound_s=QD_RESUME_S, resume_chunks_solved=resume_solves,
          resume_bitwise=same, k5_launches=k5, objective_calls=calls)
    if solved != n_chunks:
        raise AssertionError(f"{solved} solves for {n_chunks} chunks")
    check_canonical(flat)
    if not converged >= QD_CONVERGED_SHARE:
        raise AssertionError(f"{converged:.5f} of the lanes converged")
    if not (same and resume_solves == 0 and resume_s < QD_RESUME_S):
        raise AssertionError(
            f"the resume: bitwise {same}, {resume_solves} chunks solved, "
            f"{resume_s:.3f} s")

    qd_held_lanes(tq, builder, model, axes4, flat)
    return params, k5


def qd_held_lanes(tq, builder, model, axes4, flat):
    """Phase 29 c, the held lanes: an equatorial and a polar chunk refitted
    against the whole-grid fit bit for bit, in f64, by LM, with the
    likelihood summed in f32, and the two controls."""
    from glomargridding_tpu_torch import (
        Coordinates,
        EllipseBuilder,
        EllipseModel,
    )

    lat, lon, glat, _ = axes4
    n = glat.size
    chunk = tq.CHUNK_SIZE
    qc = flat["qc_code"].astype(int)
    fitted = np.column_stack([flat["Lx"], flat["Ly"], flat["theta"]])
    chunks = [np.arange(s0, s0 + chunk)
              for s0 in qd_chunk_starts(n, chunk, lat)]
    lanes = np.concatenate(chunks)
    f32 = subset_fitter(builder, model, "nm", tq.FIT_KW["tol"],
                        fit_kw=tq.FIT_KW)
    _, pm32, qc32, _ = fit_lanes(f32, chunks)
    if not (np.array_equal(pm32, fitted[lanes])
            and np.array_equal(qc32, qc[lanes])):
        raise AssertionError("the held lanes are not the whole-grid fit's")
    # f64 on the same cube (the f32 cube's values in f64, as phase 16)
    coords64 = {"time": np.arange(tq.T_TRAIN), "latitude":
                lat.astype(np.float64), "longitude": lon.astype(np.float64)}
    builder64 = EllipseBuilder(builder.data.double(),
                               Coordinates(coords64), cor_mode="lazy")
    (_, pm64, qc64, _), f64_s = timed_s(lambda: fit_lanes(subset_fitter(
        builder64, model, "nm", tq.FIT_KW["tol"], fit_kw=tq.FIT_KW), chunks))
    del builder64
    (_, pm_lm, qc_lm, _), lm_s = timed_s(lambda: fit_lanes(subset_fitter(
        builder, model, "lm", LM_TOL, fit_kw=tq.FIT_KW), chunks))
    summed = dict(f32, fit=lambda sel: summed_in_f32_fit(f32, sel))
    _, pm_s, qc_s, _ = fit_lanes(summed, chunks)
    # the controls on the equatorial chunk alone
    _, pm_w, qc_w, _ = fit_lanes(subset_fitter(
        builder, EllipseModel(**{**tq.FIT_MODEL, "v": 0.5}), "lm", LM_TOL,
        fit_kw=tq.FIT_KW), chunks[:1])
    _, _, qc_tight, _ = fit_lanes(subset_fitter(
        builder, model, "nm", QD_CONTROL_TOL, fit_kw=tq.FIT_KW), chunks[:1])
    lengths = ("Lx_rel", "Ly_rel")
    ellipse = (*lengths, "theta_abs")

    def share(pm, qc_a, rows, names=ellipse):
        return share_within(fit_deviation(pm[rows], pm64[rows], (
            qc_a[rows] == 0) & (qc64[rows] == 0)), names)

    shares = {}
    for label, rows in (("equator", slice(0, chunk)),
                        ("polar", slice(chunk, 2 * chunk))):
        shares[label] = {
            "nm_f32_vs_f64_lengths": share(pm32, qc32, rows, lengths),
            "nm_f32_vs_f64_ellipse": share(pm32, qc32, rows),
            "summed_f32_vs_f64_lengths": share(pm_s, qc_s, rows, lengths),
            "summed_f32_vs_f64_ellipse": share(pm_s, qc_s, rows),
            "lm_f32_vs_nm_f64": share(pm_lm, qc_lm, rows),
            "qc0_in_both": int(np.sum((qc32[rows] == 0) & (qc64[rows] == 0))),
        }
    nu_share = share(pm_w, qc_w, slice(0, chunk))
    tight_converged = float(np.mean(qc_tight != 9))
    phase(29, "c_held_lanes", lanes=lanes.size,
          starts="|".join(str(c[0]) for c in chunks),
          subset_vs_whole_grid="bitwise", nm_f64_s=f"{f64_s:.3f}",
          lm_f32_s=f"{lm_s:.3f}", rel_tol=FIT_REL_TOL,
          theta_tol=FIT_THETA_TOL,
          **{f"{label}_{k}": (v if isinstance(v, int) else f"{v:.4f}")
             for label, d in shares.items() for k, v in d.items()},
          phase16_share_nm_f32=f"{FIT_SHARE_NM_F32}(printed)",
          phase16_share_nm_f32_ellipse=(
              f"{FIT_SHARE_NM_F32_ELLIPSE}(printed)"),
          share_bound_lm=FIT_SHARE_LM,
          control_lm_nu_0_5_share=f"{nu_share:.4f}",
          control_tol_1e_12_converged=f"{tight_converged:.4f}")
    # The f32 simplex does not reach phase 16's shares here (measured on
    # an NVIDIA H100 80GB HBM3: 44% of the equatorial lanes within 1% on
    # the lengths against 71% at 1 degree; the 2,048 nearest columns of
    # a 0.5-degree grid span ~1,400 km, so the likelihood is flatter and
    # f32's rounding moves where the simplex stops): those bounds are
    # printed against it, not held. Held: the port's f64 sum still fits
    # more equatorial lanes than the reference's f32 sum (the polar
    # chunk, where the simplex ends on bounds, is printed), and
    # Levenberg-Marquardt, the lane to run in f32, below.
    eq = shares["equator"]
    for name in ("lengths", "ellipse"):
        if not eq[f"nm_f32_vs_f64_{name}"] > eq[f"summed_f32_vs_f64_{name}"]:
            raise AssertionError(
                f"the likelihood summed in f32 fits as many {name} as the "
                f"one summed in f64: {eq[f'summed_f32_vs_f64_{name}']:.4f}")
    for label, d in shares.items():
        if not d["lm_f32_vs_nm_f64"] >= FIT_SHARE_LM:
            raise AssertionError(
                f"f32 LM, {label}: {d['lm_f32_vs_nm_f64']:.4f}")
    if not nu_share < FIT_SHARE_LM:
        raise AssertionError("the LM bound passes the fit at nu = 0.5")
    if not tight_converged < QD_CONVERGED_SHARE:
        raise AssertionError("the convergence bound passes tol 1e-12")


def qd_stream_checks(tq, dev, mv, fields, glat, glon, max_dist):
    """Phase 29 d: K3 against the wide path, rows against an f64 slab of
    the plain twin, each with the 2,700 km control, and the walls."""
    from glomargridding_tpu_torch.ops.cuda.ellipse import (
        beyond_cutoff,
        ellipse_tile_torch,
        pack_points,
    )

    n = glat.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    x9 = torch.randn((n, 9), generator=gen, device=dev)
    y8 = mv(x9[:, :8].contiguous())
    wide = mv(x9)[:, :8]
    k3_vs_wide = max_rel(y8, wide)
    control_mv, _, _ = tq.stream_operator(glat, glon, fields,
                                          QD_CUTOFF_CONTROL_KM, dev)
    k3_control = max_rel(control_mv(x9)[:, :8], wide)
    del wide
    r0 = n // 2
    rows = torch.arange(r0, r0 + QD_SLAB_ROWS, device=dev)
    E = torch.zeros((n, QD_SLAB_ROWS), device=dev)
    E[rows, torch.arange(QD_SLAB_ROWS, device=dev)] = 1.0
    slab = mv(E).T
    slab_control = control_mv(E).T
    del E, control_mv
    P32 = pack_points(*tq.stream_inputs(glat, glon, fields, device=dev))
    P64 = pack_points(*tq.stream_inputs(glat, glon, fields, torch.float64,
                                        dev))
    oracle = torch.empty((QD_SLAB_ROWS, n), dtype=torch.float64, device=dev)
    step = 16384
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        tile = ellipse_tile_torch(P64[rows], P64[c0:c1], 1.5)
        far = beyond_cutoff(P32[rows], P32[c0:c1], max_dist)
        oracle[:, c0:c1] = torch.where(far, torch.zeros_like(tile), tile)
    oracle[torch.arange(QD_SLAB_ROWS, device=dev), rows] += (
        P64[rows, 6] ** 2)
    scale = torch.max(torch.abs(oracle)).item()
    slab_err = max_rel(slab, oracle, scale)
    slab_ctrl = max_rel(slab_control, oracle, scale)
    del oracle, slab, slab_control, P64, P32
    x8 = x9[:, :8].contiguous()
    x1024 = torch.randn((n, WIDE_COLS), generator=gen, device=dev)
    walls = {"y8_s": wall_median_s(lambda: mv(x8)),
             "y1024_s": wall_median_s(lambda: mv(x1024)),
             "y1024_window_s": window_wall_s(mv, pack_points(
                 *tq.stream_inputs(glat, glon, fields, device=dev)), x1024,
                 max_dist)}
    stats = mv.band_stats
    phase(29, "d_stream", max_dist_km=max_dist, bw=stats["bw"],
          block=stats["block"], kept_pairs=stats["kept_pairs"],
          wide_pairs=stats["wide_pairs"], fused_pairs=stats["fused_pairs"],
          k3_vs_wide=f"{k3_vs_wide:.3e}", tol=QD_STREAM_TOL,
          control_k3_vs_wide_2700km=f"{k3_control:.3e}",
          slab_rows=QD_SLAB_ROWS, slab_vs_f64_plain=f"{slab_err:.3e}",
          slab_tol=QD_SLAB_TOL, control_slab_2700km=f"{slab_ctrl:.3e}",
          **{k: f"{v:.4f}" for k, v in walls.items()})
    check("phase 29 K3 vs the wide path", k3_vs_wide, QD_STREAM_TOL)
    check("phase 29 rows vs the f64 slab", slab_err, QD_SLAB_TOL)
    if not (k3_control > QD_STREAM_TOL and slab_ctrl > QD_SLAB_TOL):
        raise AssertionError("a phase 29 d bound passes the 2,700 km cutoff")


def qd_clip_checks(tq, dev, mv, n, trace, psd, true_rank, split, log,
                   total):
    """Phase 29 e: the clip's split, its trace and explained share, and a
    second clip from another start block on a sub-block."""
    trace_rel = abs(psd.trace() - trace) / trace
    r = psd.effective_rank
    explained = (float(psd.gains.double().sum())
                 + r * float(psd.floor[0])) / trace
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    other, _ = tq.psd_repair(mv, n, trace, generator=gen, device=dev)
    keep = dict(tq.CLIP_KW)
    tq.CLIP_KW["target_variance_fraction"] = CLIP_WRONG_TARGET
    try:
        wrong, _ = tq.psd_repair(mv, n, trace, generator=gen, device=dev)
    finally:
        tq.CLIP_KW.clear()
        tq.CLIP_KW.update(keep)
    cells = torch.as_tensor(np.linspace(0, n - 1, QD_SUB_CELLS).astype(
        np.int64), device=dev)
    a = dense_sub(psd, cells)
    scale = torch.max(torch.abs(a)).item()
    clip_err = max_rel(dense_sub(other, cells), a, scale)
    clip_ctrl = max_rel(dense_sub(wrong, cells), a, scale)
    del a
    # the retained eigenvalues of the two clips, over the largest
    ritz = [(p.gains[:r].double() + p.floor[0].double()).cpu()
            for p in (psd, other)]
    ritz_err = float(torch.max(torch.abs(ritz[0] - ritz[1])) / ritz[0][0])
    phase(29, "e_clip", target=tq.CLIP_KW["target_variance_fraction"],
          k0=tq.CLIP_KW["k0"], max_rank=tq.CLIP_KW["max_rank"],
          rank=f"{true_rank}->{psd.rank}", effective_rank=r,
          other_start_rank=other.effective_rank,
          stages=split["stages"], sweeps=split["sweeps"],
          columns=split["columns"], final_resid_over_theta1=log.accepted,
          clip_s=f"{total:.3f}", sweeps_s=f"{split['sweep_s']:.3f}",
          trace=f"{trace:.6g}", trace_rel=f"{trace_rel:.3e}",
          trace_tol=TRACE_TOL, explained=f"{explained:.4f}",
          sub_cells=QD_SUB_CELLS, other_start=f"{clip_err:.3e}",
          other_start_ritz_over_theta1=f"{ritz_err:.3e}",
          tol=QD_CLIP_TOL, control_target_0_8=f"{clip_ctrl:.3e}")
    check("phase 29 trace of the factors", trace_rel, TRACE_TOL)
    if not explained >= tq.CLIP_KW["target_variance_fraction"]:
        raise AssertionError(f"the clip explains {explained:.4f}")
    check("phase 29 clip from another start block", clip_err, QD_CLIP_TOL)
    if not clip_ctrl > QD_CLIP_TOL:
        raise AssertionError("the clip bound passes the target 0.80 clip")


def qd_ensemble_checks(tq, dev, psd):
    """Phase 29 f: kriging and 100 members off the factors through the
    twin, f32 against f64 factors, and the consistency of a truth drawn
    from the factors."""
    from glomargridding_tpu_torch import LowRankPSD, lowrank_kriging

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    idx, truth, y, E = tq.observations(psd, gen)
    (res, members), first_s = timed_s(lambda: tq.ensemble(psd, idx, y, E,
                                                          gen))
    for name, got in (*zip(res._fields, res), ("members", members)):
        if got.shape[-1] != psd.n or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"phase 29 {name} malformed")
    warm_s = wall_median_s(lambda: tq.ensemble(psd, idx, y, E, gen))
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    errs = kriging_errs(res, lowrank_kriging(psd64, idx, y.double(),
                                             E.double()),
                        float(torch.sqrt(psd.diagonal().max())))
    del psd64
    triple = tq.consistency(res, members, truth)
    ratio = max(triple.values()) / min(triple.values())
    wrong = LowRankPSD(psd.vectors, psd.gains * QD_COVARIANCE_CONTROL,
                       psd.floor * QD_COVARIANCE_CONTROL)
    res_c, members_c = tq.ensemble(wrong, idx, y, E, gen)
    control = tq.consistency(res_c, members_c, truth)
    control_ratio = max(control.values()) / min(control.values())
    phase(29, "f_kriging_members", obs=tq.N_OBS, members=tq.N_MEMBERS,
          first_s=f"{first_s:.4f}", warm_s=f"{warm_s:.4f}",
          tol=QD_FACTOR_TOL, **{f"f32_vs_f64_{k}": f"{v:.3e}"
                                for k, v in errs.items()},
          **{k: f"{v:.4f}" for k, v in triple.items()},
          ratio=f"{ratio:.4f}", ratio_bound=CONSISTENCY_RATIO,
          control_covariance_x1_5_ratio=f"{control_ratio:.4f}")
    for k in ("field", "uncertainty"):
        check(f"phase 29 f32 vs f64 {k}", errs[k], QD_FACTOR_TOL)
    check("phase 29 consistency: largest over smallest of RMSE, spread "
          "and uncertainty", ratio, CONSISTENCY_RATIO)
    if not control_ratio > CONSISTENCY_RATIO:
        raise AssertionError("the consistency bound passes C x 1.5")


def phase29_quarter_degree(dev):
    """Phase 29: examples/torch_nonstationary_quarter_degree.py at 259,200
    cells with nothing cut, stage by stage through the twin; returns the
    launches (K3, K4) of its stream and clip and K5's of its fit."""

    tq = examples_module("torch_nonstationary_quarter_degree")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    cube, builder, axes4 = qd_cube_and_rows(tq, dev, gen)
    params, k5 = qd_fit(tq, dev, builder, axes4)
    del builder, cube
    _, _, glat, glon = axes4
    fields, n_fit = tq.fitted_fields(params)
    max_dist = tq.max_dist_km()
    # the path: the stream on the fitted fields and the clip, counted
    reset_ellipse_counts()
    mv, n, trace = tq.stream_operator(glat, glon, fields, max_dist, dev)
    mv(torch.ones((n,), device=dev))
    (psd, true_rank), split, log, total = clip_instrumented(
        mv, n, trace, clip=lambda op: tq.psd_repair(op, n, trace, gen,
                                                    device=dev))
    sync()
    k3 = require_launches("K3 (the 0.5-degree stream)",
                          COUNTS["k3.launches"])
    k4 = require_launches("K4 (the 0.5-degree stream)",
                          COUNTS["k4.launches"])
    qd_stream_checks(tq, dev, mv, fields, glat, glon, max_dist)
    qd_clip_checks(tq, dev, mv, n, trace, psd, true_rank, split, log, total)
    del mv
    qd_ensemble_checks(tq, dev, psd)
    phase(29, "quarter_degree", cells=n, fitted=n_fit, k3_launches=k3,
          k4_launches=k4, seconds=f"{time.perf_counter() - t0:.1f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return k3, k4, k5


def clip_stage(out):
    """The name of a twin's clip stage in its ``times``."""
    return next(k for k in out["times"] if "PSD repair" in k)


def phase30_lowrank_65k(dev):
    """examples/torch_nonstationary_65k_lowrank.py: K2's bf16 store, the
    clip, the factored ensemble; held against f64 factors as phase 14
    holds its call. Returns K2's launches."""
    from glomargridding_tpu_torch import LowRankPSD, lowrank_kriging

    tm = examples_module("torch_nonstationary_65k_lowrank")
    reset_ellipse_counts()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    out = tm.run(device=dev, generator=gen, verbose=False)
    k2 = require_launches("K2 (the 65k low-rank store)",
                          COUNTS["k2.launches"])
    psd, res = out["psd"], out["result"]
    psd64 = LowRankPSD(psd.vectors.double(), psd.gains.double(),
                       psd.floor.double())
    scale = float(torch.sqrt(psd.diagonal().max()))
    idx, y, E = out["idx"], out["y"].double(), out["E"].double()
    errs = kriging_errs(res, lowrank_kriging(psd64, idx, y, E), scale)
    control = kriging_errs(res, lowrank_kriging(psd64, idx, y, E * 1.1),
                           scale)
    del psd64
    phase(30, "a_lowrank_65k", cells=psd.n, k2_launches=k2,
          store_build_s=f"{out['times']['bf16 operator assembly']:.4f}",
          rank=f"{out['true_rank']}->{psd.rank}",
          trace_rel=f"{out['trace_rel']:.3e}", trace_tol=TRACE_TOL,
          clip_s=f"{out['times'][clip_stage(out)]:.4f}",
          members_first_s=(
              f"{out['times'][f'kriging + {tm.N_MEMBERS} members']:.4f}"),
          members_warm_s=f"{out['times']['kriging + members (warm)']:.4f}",
          rmse=f"{out['rmse']:.4f}", spread=f"{out['spread']:.4f}",
          uncertainty=f"{out['uncertainty']:.4f}", tol=KRIGING_TOL,
          **{f"f32_vs_f64_{k}": f"{v:.3e}" for k, v in errs.items()},
          control_error_x1_1_field=f"{control['field']:.3e}")
    check("phase 30 trace of the factors", out["trace_rel"], TRACE_TOL)
    for k, v in errs.items():
        check(f"phase 30 low-rank f32 vs f64 {k}", v, KRIGING_TOL)
    if not control["field"] > KRIGING_TOL:
        raise AssertionError("the 65k bound passes E x 1.1")
    return k2


def phase30_large_ensemble(dev):
    """examples/torch_large_ensemble_65k.py: K1's tiles against
    kernel_block's plain form, f32 members against f64 on the same
    normals, draws per second. Returns K1's launches of the f32 run."""

    tl = examples_module("torch_large_ensemble_65k")
    COUNTS["k1.launches"] = 0
    out = tl.run(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 41), verbose=False)
    k1 = require_launches("K1 (the large ensemble)",
                          COUNTS["k1.launches"])
    out64 = tl.run(device=dev, dtype=torch.float64, generator=torch.Generator(
        device=dev).manual_seed(SEED + 41), verbose=False)
    members_err = max_rel(out["members"], out64["members"])
    field_err = max_rel(out["field"], out64["field"])
    # the control: the f64 members with the observation errors x 1.1
    lat, lon = tl.grid()
    la, lo = tl.cells(lat, lon, torch.float64, dev)
    idx, y, err = tl.observations(la.shape[0])
    noise = tl.draw_noise(out64["sampler"], torch.Generator(
        device=dev).manual_seed(SEED + 41))
    states = out64["sampler"].draw(tl.N_MEMBERS, noise=noise["states"]).T
    _, members_c = tl.krige_and_perturb(la, lo, idx, y, err * 1.1, states,
                                        noise["obs"])
    control = max_rel(out["members"], members_c)
    del out64, states, members_c
    # K1's tiles (+ nugget) against kernel_block with the full arcsin
    tile_errs = {}
    for dtype in (torch.float32, torch.float64):
        la_d, lo_d = tl.cells(lat, lon, dtype, dev)
        idx_t = torch.as_tensor(idx, device=dev)
        width = -(-la_d.shape[0] // tl.N_BLOCKS)
        inside = idx_t < width
        rows = torch.arange(idx_t.numel(), device=dev)
        la_o, lo_o = la_d[idx_t], lo_d[idx_t]
        got = tl.kernel_block(la_o, lo_o, la_d[:width], lo_d[:width],
                              (rows[inside], idx_t[inside]))
        a64, o64 = la_o.double(), lo_o.double()
        b64, p64 = la_d[:width].double(), lo_d[:width].double()
        a = (torch.sin((a64[:, None] - b64[None, :]) / 2.0) ** 2
             + torch.cos(a64)[:, None] * torch.cos(b64)[None, :]
             * torch.sin((o64[:, None] - p64[None, :]) / 2.0) ** 2)
        d = 2.0 * 6371.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
        want = tl.PSILL * torch.exp(-d / tl.RANGE_KM)
        same = (torch.abs(a64[:, None] - b64[None, :]) < 1e-9) & (
            torch.abs(o64[:, None] - p64[None, :]) < 1e-9)
        want = want + torch.where(same, tl.NUGGET, 0.0)
        tile_errs[dtype] = max_rel(got, want, tl.PSILL)
        if dtype == torch.float32:
            tile_control = max_rel(tl.covariance_block(
                la_o, lo_o, la_d[:width], lo_d[:width]), want, tl.PSILL)
    phase(30, "b_large_ensemble_65k", cells=la.shape[0], obs=tl.N_OBS,
          members=tl.N_MEMBERS, k1_launches=k1,
          l_max=out["sampler"].l_max,
          sampler_s=f"{out['times']['sampler']:.3f}",
          cold_s=f"{out['times']['cold']:.4f}",
          warm_s=f"{out['times']['warm']:.4f}",
          warm_draws_s=f"{out['times']['warm_draws']:.4f}",
          warm_krige_s=f"{out['times']['warm_krige']:.4f}",
          draws_per_s=f"{out['draws_per_s']:.1f}",
          k1_tile_vs_kernel_block_f32=f"{tile_errs[torch.float32]:.3e}",
          k1_tile_vs_kernel_block_f64=f"{tile_errs[torch.float64]:.3e}",
          tile_tol=f"{tl.NUGGET_TOL[torch.float32]}|"
                   f"{tl.NUGGET_TOL[torch.float64]}",
          control_tile_without_nugget=f"{tile_control:.3e}",
          members_f32_vs_f64=f"{members_err:.3e}",
          field_f32_vs_f64=f"{field_err:.3e}", tol=LE_MEMBERS_TOL,
          control_error_x1_1=f"{control:.3e}",
          spread_mean=f"{out['spread_mean']:.4f}")
    for dtype, err in tile_errs.items():
        check(f"phase 30 K1 tile vs kernel_block {dtype}", err,
              tl.NUGGET_TOL[dtype])
    check("phase 30 members f32 vs f64", members_err, LE_MEMBERS_TOL)
    if not (tile_control > tl.NUGGET_TOL[torch.float32]
            and control > LE_MEMBERS_TOL):
        raise AssertionError("a phase 30 b bound passes its control")
    return k1


def phase30_ellipse_40k(dev):
    """examples/torch_ellipse_1deg_covariance.py: K4's 40,000-point build,
    its checks, a block against the plain twin in f64. Returns K4's
    launches."""
    from glomargridding_tpu_torch.ops.cuda import ellipse as te

    tc = examples_module("torch_ellipse_1deg_covariance")
    reset_ellipse_counts()
    out = tc.run(device=dev, verbose=False)
    k4 = require_launches("K4 (the 40,000-point build)",
                          COUNTS["k4.launches"])
    cov = out["cov"]
    lats, lons, fields = tc.points()
    P64 = te.pack_points(*tc.kernel_inputs(lats, lons, fields,
                                           torch.float64, dev))
    b = EC_BLOCK
    want = te.ellipse_tile_torch(P64[:b], P64[:b], tc.NU)
    want.diagonal().add_(P64[:b, 6] ** 2)
    scale = torch.max(torch.abs(want)).item()
    err = max_rel(cov[:b, :b], want, scale)
    control_t = te.ellipse_tile_torch(P64[:b], P64[:b], 1.5)
    control_t.diagonal().add_(P64[:b, 6] ** 2)
    control = max_rel(control_t, want, scale)
    eigs = out["eigs"]
    phase(30, "c_ellipse_40k", points=tc.N_POINTS, nu=tc.NU, k4_launches=k4,
          gb=f"{cov.numel() * 4 / 1e9:.2f}",
          cold_s=f"{out['times']['cold']:.4f}",
          warm_s=f"{out['times']['warm']:.4f}",
          gpairs_per_s=f"{out['gpairs_per_s']:.1f}", block=b,
          vs_plain_f64=f"{err:.3e}", tol=EC_TOL,
          control_nu_1_5=f"{control:.3e}", diag_rtol=tc.DIAG_RTOL,
          symmetry_tol=tc.SYMMETRY_TOL,
          spectrum=f"{eigs.min():.2e}|{eigs.max():.2e}")
    check("phase 30 K4 block vs the plain twin in f64", err, EC_TOL)
    if not control > EC_TOL:
        raise AssertionError("the 40,000-point bound passes nu = 1.5")
    return k4


def phase30_examples(dev):
    """Phase 30, the three 1-degree twins at full size; returns the
    launches (K1, K2, K4) of their paths."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k2 = phase30_lowrank_65k(dev)
    k1 = phase30_large_ensemble(dev)
    k4 = phase30_ellipse_40k(dev)
    phase(30, "examples_1deg", seconds=f"{time.perf_counter() - t0:.1f}")
    return k1, k2, k4



# ---------------------------------------------------------------------------
# phase 31: the 0.1-degree twin at full width
# ---------------------------------------------------------------------------
# examples/torch_nonstationary_tenth_degree.py at 6,480,000 cells, f32.
# (a) Sigma and sqrt det Sigma on the card against an f64 build on the
# host, over max |.|; the control turns theta by 1e-3 rad
TD_FIELD_TOL = 1e-6
TD_THETA_CONTROL = 1e-3
# (c) rows of the W = 64 application against an f64 slab of the plain
# twin over all 6,480,000 columns (no band), over max |y|; the control
# plans the windows at 2,700 km while the kernel cuts at 3,000 km
TD_SLAB_TOL = 1e-5
TD_CONTROL_KM = 2700.0
TD_SLAB_COLS = 1 << 18
# K4, the GEMM and the gather timed apart over a sample of row blocks
# (CUDA events), at the operator's rows and at the 64 of ``_block_rows``
TD_SAMPLE_BLOCKS = 24
# (e) f32 kriging and members against f64 on the same factors and
# normals; RMSE / spread / uncertainty within CONSISTENCY_RATIO, the
# control the covariance x 1.5
TD_FACTOR_TOL = KRIGING_TOL
TD_COVARIANCE_CONTROL = 1.5


def td_fields(tt, dev, glat, glon, fields):
    """Phase 31 a: Sigma and sqrt det on the card against the host's f64
    build, and the control."""
    def sigma(dtype, device, theta_shift=0.0):
        Lx, Ly, theta, stdev = fields
        inputs = tt.operator_inputs(glat, glon, (Lx, Ly, theta + np.float32(
            theta_shift), stdev), dtype, device)
        return torch.cat([inputs[2], inputs[3][:, None]], dim=1)

    (card, card_s) = timed_s(lambda: sigma(torch.float32, dev))
    host = sigma(torch.float64, "cpu")
    errs = [max_rel(card[:, k].cpu(), host[:, k]) for k in range(4)]
    control = max_rel(sigma(torch.float32, dev, TD_THETA_CONTROL)[:, :3]
                      .cpu(), host[:, :3])
    del card, host
    phase(31, "a_fields", cells=glat.size, card_s=f"{card_s:.3f}",
          **{f"{k}_vs_f64_host": f"{e:.3e}" for k, e in zip(
              ("s00", "s01", "s11", "sqrt_det"), errs)},
          tol=TD_FIELD_TOL, control_theta_1e_3=f"{control:.3e}")
    check("phase 31 Sigma on the card vs the f64 host build", max(errs),
          TD_FIELD_TOL)
    if not control > TD_FIELD_TOL:
        raise AssertionError("the field bound passes theta + 1e-3")


def td_certificate(P, windows, max_dist):
    """The least latitude gap, in km, between a row block and the
    columns outside its window, over every block (latitude-sorted
    points: the column just before and just after the window)."""
    from glomargridding_tpu_torch.constants import RADIUS_OF_EARTH_KM

    lat = P[:, 0].double().cpu().numpy()
    w = np.asarray(windows)
    r0, r1, c0, c1 = (w[:, k] for k in range(4))
    n = lat.size
    rmin, rmax = lat[r0], lat[r1 - 1]
    before = np.where(c0 > 0, rmin - lat[np.maximum(c0 - 1, 0)], np.inf)
    after = np.where(c1 < n, lat[np.minimum(c1, n - 1)] - rmax, np.inf)
    return float(np.min(np.minimum(before, after))) * RADIUS_OF_EARTH_KM


def td_slab_oracle(P32, P64, rows, glon, max_dist):
    """C(rows, all columns) X's f64 oracle tile by tile: the plain twin in
    f64 over every column, zero beyond the cutoff decided on the f32
    points (as the kernels decide it), and the f32 twin's value at pairs
    180 degrees of longitude apart (the +-pi step)."""
    from glomargridding_tpu_torch.ops.cuda.ellipse import (
        beyond_cutoff,
        ellipse_tile_torch,
    )

    n = P64.shape[0]
    lon_r = torch.as_tensor(glon, device=P64.device).double()[rows]
    lon_all = torch.as_tensor(glon, device=P64.device).double()
    for c0 in range(0, n, TD_SLAB_COLS):
        c1 = min(c0 + TD_SLAB_COLS, n)
        tile = ellipse_tile_torch(P64[rows], P64[c0:c1], 1.5)
        far = beyond_cutoff(P32[rows], P32[c0:c1], max_dist)
        tile = torch.where(far, torch.zeros_like(tile), tile)
        step = torch.abs(torch.abs(lon_r[:, None] - lon_all[None, c0:c1])
                         - 180.0) < 1e-3
        if bool(step.any()):
            t32 = ellipse_tile_torch(P32[rows], P32[c0:c1], 1.5).double()
            t32 = torch.where(far, torch.zeros_like(t32), t32)
            tile = torch.where(step, t32, tile)
        yield c0, c1, tile


def td_application(tt, dev, mv, glat, glon, fields, rng):
    """Phase 31 c: the W = 64 application, three row blocks of it against
    the f64 slab over all columns, with the 2,700 km control."""
    from glomargridding_tpu_torch.models.ellipse.covariance import (
        _apply_wide,
        stream_plan,
    )
    from glomargridding_tpu_torch.ops.cuda.ellipse import pack_points

    n = glat.size
    X, draw_s = timed_s(lambda: tt.demonstration_block(rng, n, dev))
    Y, apply_s = timed_s(lambda: mv(X))
    k4 = COUNTS["k4.launches"]
    stats = mv.band_stats
    block = stats["block"]
    P32 = pack_points(*tt.operator_inputs(glat, glon, fields, device=dev))
    P64 = pack_points(*tt.operator_inputs(glat, glon, fields, torch.float64,
                                          dev))
    lat = P32[:, 0].double().cpu().numpy()
    windows, _, _ = stream_plan(lat, lat, block, tt.MAX_DIST_KM)
    control, _, _ = stream_plan(lat, lat, block, TD_CONTROL_KM)
    n_lon = tt.M_LON
    lon_row = n // 2 // n_lon * n_lon  # the first cell north of 0
    picks = {"equator": (lon_row + n_lon // 2) // block,
             "north": len(windows) - 1,
             # a block starting at -179.95: a latitude row's first cell
             "antimeridian": next(b for b in range(lon_row // block,
                                                   len(windows))
                                  if windows[b][0] % n_lon == 0)}
    errs, ctrl = {}, {}
    for name, b in picks.items():
        r0, r1 = windows[b][:2]
        rows = torch.arange(r0, r1, device=dev)
        want = (P64[r0:r1, 6] ** 2)[:, None] * X[r0:r1].double()
        for c0, c1, tile in td_slab_oracle(P32, P64, rows, glon,
                                           tt.MAX_DIST_KM):
            want += tile @ X[c0:c1].double()
        scale = torch.max(torch.abs(want)).item()
        errs[name] = max_rel(Y[r0:r1], want, scale)
        y_ctrl = _apply_wide(P32, X, [control[b]], 1.5,
                             "Modified_Met_Office", tt.MAX_DIST_KM)[r0:r1]
        y_ctrl += (P32[r0:r1, 6] ** 2)[:, None] * X[r0:r1]
        ctrl[name] = max_rel(y_ctrl, want, scale)
    gap_km = td_certificate(P32, windows, tt.MAX_DIST_KM)
    starts = {k: f"{windows[b][0]}:{float(glat[windows[b][0]]):.2f}:"
              f"{float(glon[windows[b][0]]):.2f}" for k, b in picks.items()}
    phase(31, "c_application_w64", draw_s=f"{draw_s:.2f}",
          application_s=f"{apply_s:.2f}",
          gpairs_per_s=f"{stats['kept_pairs'] / apply_s / 1e9:.1f}",
          blocks="|".join(f"{k}@{v}" for k, v in starts.items()),
          **{f"{k}_vs_f64_slab": f"{v:.3e}" for k, v in errs.items()},
          tol=TD_SLAB_TOL,
          **{f"control_2700km_{k}": f"{v:.3e}" for k, v in ctrl.items()},
          certificate_min_gap_km=f"{gap_km:.1f}", max_dist_km=tt.MAX_DIST_KM)
    check("phase 31 rows of the W = 64 application vs the f64 slab",
          max(errs.values()), TD_SLAB_TOL)
    if not max(ctrl.values()) > TD_SLAB_TOL:
        raise AssertionError("the slab bound passes windows planned at "
                             "2,700 km")
    if not gap_km > tt.MAX_DIST_KM:
        raise AssertionError(f"the band certificate: {gap_km:.1f} km")
    return X, apply_s, k4


def td_block_pieces(by_chunk, x, window, ids):
    """A row block's column points and x rows: its window of the points
    and `x`, or (`ids`) its active chunks gathered."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov

    _, _, c0, c1 = window
    if ids is None:
        cols = by_chunk[0].view(-1, by_chunk[0].shape[2])
        return cols[c0:c1], x[c0:c1]
    return tcov._gathered(by_chunk, ids)


def td_split(P, X, windows, chunks, widths=(64, 96)):
    """K4, the GEMM and the gather apart, CUDA events over
    TD_SAMPLE_BLOCKS row blocks spread over the grid, each block against
    its window (`chunks` None) or its active chunks:
    {width: (gather ms, K4 ms, GEMM ms, pairs)}, summed over the sample."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda.ellipse import ellipse_tile

    picks = np.linspace(0, len(windows) - 1, TD_SAMPLE_BLOCKS).astype(int)
    block = max(r1 - r0 for r0, r1, _, _ in windows)
    width = max(c1 - c0 for _, _, c0, c1 in windows)
    ws = torch.empty(block * width, device=P.device)
    out = {}
    for w in widths:
        x = X[:, :w] if w <= X.shape[1] else torch.cat(
            [X, X[:, :w - X.shape[1]]], dim=1)
        by_chunk = tcov._by_chunk(P, x)
        y = torch.zeros((block, w), device=P.device)
        gather_ms = k4_ms = gemm_ms = 0.0
        pairs = 0
        for b in picks:
            r0, r1 = windows[b][:2]
            ids = (None if chunks is None
                   else chunks[1][chunks[0][b]:chunks[0][b + 1]])
            gather_ms += cuda_time_ms(lambda: td_block_pieces(
                by_chunk, x, windows[b], ids), iters=3)
            cols, xs = td_block_pieces(by_chunk, x, windows[b], ids)
            tile = ws[:(r1 - r0) * cols.shape[0]].view(r1 - r0, -1)
            k4_ms += cuda_time_ms(lambda: ellipse_tile(
                P[r0:r1], cols, 1.5, "Modified_Met_Office", 3000.0,
                out=tile), iters=3)
            gemm_ms += cuda_time_ms(lambda: y[:r1 - r0].addmm_(tile, xs),
                                    iters=3)
            pairs += (r1 - r0) * cols.shape[0]
        out[w] = (gather_ms, k4_ms, gemm_ms, pairs)
    return out


def td_times(tt, dev, X, glat, glon, fields, block):
    """K4, the GEMM and the gather with the longitude certificate at the
    operator's rows and at the 64 of ``_block_rows``, and each block
    against its whole window at the operator's rows, as seconds an
    application (the sample's mean times the blocks)."""
    from glomargridding_tpu_torch.models.ellipse import covariance as tcov
    from glomargridding_tpu_torch.ops.cuda.ellipse import pack_points

    P = pack_points(*tt.operator_inputs(glat, glon, fields, device=dev))
    lat = P[:, 0].double().cpu().numpy()
    values = {}
    for label, rows, certified in (
            ("certified", block, True),
            ("certified", tcov._block_rows(P.shape[0], None), True),
            ("window", block, False)):
        windows, _, bw = tcov.stream_plan(lat, lat, rows, tt.MAX_DIST_KM)
        chunks = (tcov._active_chunks(P, windows, bw, tt.MAX_DIST_KM)
                  if certified else None)
        scale = len(windows) / TD_SAMPLE_BLOCKS / 1e3
        for w, (g, k4, gemm, pairs) in td_split(P, X, windows,
                                                chunks).items():
            values[f"{label}_{rows}_w{w}"] = (
                f"gather:{g * scale:.2f}s,K4:{k4 * scale:.2f}s,"
                f"GEMM:{gemm * scale:.2f}s,{pairs / k4 / 1e6:.0f}Gpairs/s,"
                f"{2 * pairs * w / gemm / 1e9:.1f}TFLOP/s")
    return values


def td_clip(tt, dev, mv, n, trace, gen):
    """Phase 31 d: the rank-capped clip, instrumented, its trace and the
    control (the factors without their floor)."""
    from glomargridding_tpu_torch import LowRankPSD

    (psd, split, log, total) = clip_instrumented(
        mv, n, trace, clip=lambda op: tt.psd_repair(op, n, trace, gen,
                                                    device=dev))
    trace_rel = abs(psd.trace() - trace) / trace
    retained = float(psd.gains.double().sum()) / trace
    bare = LowRankPSD(psd.vectors, psd.gains, torch.zeros_like(psd.floor))
    control = abs(bare.trace() - trace) / trace
    phase(31, "d_clip", target=tt.TARGET, rank_cap=tt.rank_cap(),
          rank=psd.rank, effective_rank=psd.effective_rank,
          stages=split["stages"], sweeps=split["sweeps"],
          columns=split["columns"], final_resid_over_theta1=log.accepted,
          clip_s=f"{total:.2f}", sweeps_s=f"{split['sweep_s']:.2f}",
          retained=f"{retained:.4f}", trace=f"{trace:.6g}",
          trace_rel=f"{trace_rel:.3e}", trace_tol=TRACE_TOL,
          control_no_floor=f"{control:.3e}")
    check("phase 31 trace of the factors", trace_rel, TRACE_TOL)
    if not control > TRACE_TOL:
        raise AssertionError("the trace bound passes the factors without "
                             "their floor")
    return psd, total


def td_members(tt, psd, idx, y, E, noise, dtype):
    """Kriging and members on the factors in `dtype`, from `noise`."""
    from glomargridding_tpu_torch import LowRankPSD

    p = LowRankPSD(psd.vectors.to(dtype), psd.gains.to(dtype),
                   psd.floor.to(dtype))
    return tt.ensemble(p, idx, y.to(dtype), E.to(dtype),
                       noise=[z.to(dtype) for z in noise])


def td_ensemble(tt, dev, psd, rng, gen):
    """Phase 31 e: kriging and 100 members, first and warm, f32 against
    f64 on the same factors and normals, and the consistency of a truth
    drawn from the factors, with the covariance x 1.5 control."""
    from glomargridding_tpu_torch import LowRankPSD

    idx, truth, y, E = tt.observations(psd, rng, gen)
    n, r, m = psd.n, psd.rank, idx.numel()
    noise = [torch.randn(s, generator=gen, device=dev)
             for s in ((n, tt.N_MEMBERS), (r, tt.N_MEMBERS),
                       (m, tt.N_MEMBERS))]
    (res, members), first_s = timed_s(lambda: tt.ensemble(
        psd, idx, y, E, noise=noise))
    (res, members), warm_s = timed_s(lambda: tt.ensemble(
        psd, idx, y, E, noise=noise))
    for name, got in (*zip(res._fields, res), ("members", members)):
        if got.shape[-1] != n or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"phase 31 {name} malformed")
    res64, members64 = td_members(tt, psd, idx, y, E, noise, torch.float64)
    errs = kriging_errs(res, res64, float(torch.sqrt(psd.diagonal().max())))
    errs["members"] = max_rel(members, members64)
    del res64, members64
    triple = tt.consistency(res, members, truth)
    ratio = max(triple.values()) / min(triple.values())
    wrong = LowRankPSD(psd.vectors, psd.gains * TD_COVARIANCE_CONTROL,
                       psd.floor * TD_COVARIANCE_CONTROL)
    control = tt.consistency(*tt.ensemble(wrong, idx, y, E, noise=noise),
                             truth)
    control_ratio = max(control.values()) / min(control.values())
    phase(31, "e_kriging_members", obs=m, members=tt.N_MEMBERS,
          first_s=f"{first_s:.3f}", warm_s=f"{warm_s:.3f}",
          tol=TD_FACTOR_TOL, **{f"f32_vs_f64_{k}": f"{v:.3e}"
                                for k, v in errs.items()},
          **{k: f"{v:.4f}" for k, v in triple.items()},
          ratio=f"{ratio:.4f}", ratio_bound=CONSISTENCY_RATIO,
          control_covariance_x1_5_ratio=f"{control_ratio:.4f}")
    for k in ("field", "uncertainty", "members"):
        check(f"phase 31 f32 vs f64 {k}", errs[k], TD_FACTOR_TOL)
    check("phase 31 consistency: largest over smallest of RMSE, spread "
          "and uncertainty", ratio, CONSISTENCY_RATIO)
    if not control_ratio > CONSISTENCY_RATIO:
        raise AssertionError("the consistency bound passes C x 1.5")
    return first_s, warm_s


def phase31_tenth_degree(dev):
    """Phase 31: examples/torch_nonstationary_tenth_degree.py at 6,480,000
    cells, f32, at its own arguments, stage by stage through the twin;
    returns K4's launches on its path (the W = 64 application and the
    clip's sweeps)."""

    tt = examples_module("torch_nonstationary_tenth_degree")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    walls = {}
    glat, glon = tt.grid()
    fields, walls["fields_host"] = timed_s(
        lambda: tt.heterogeneous_ellipse_fields(glat, glon))
    td_fields(tt, dev, glat, glon, fields)
    (mv, n, trace), walls["operator"] = timed_s(
        lambda: tt.stream_operator(glat, glon, fields, device=dev))
    stats = mv.band_stats
    phase(31, "b_band_plan", cells=n, block=stats["block"],
          row_blocks=len(stats["col_starts"]), bw=stats["bw"],
          wide_pairs=f"{stats['wide_pairs']:.4e}",
          kept_pairs=f"{stats['kept_pairs']:.4e}",
          kept_share=f"{stats['kept_pairs'] / stats['wide_pairs']:.4f}",
          tile_gb=f"{stats['block'] * stats['bw'] * 4 / 1e9:.3f}",
          plan_s=f"{walls['operator']:.3f}")
    reset_ellipse_counts()
    rng = np.random.default_rng(11)
    X, walls["application_w64"], k4_demo = td_application(
        tt, dev, mv, glat, glon, fields, rng)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    reset_ellipse_counts()
    psd, walls["clip"] = td_clip(tt, dev, mv, n, trace, gen)
    k4 = require_launches("K4 (the 0.1-degree clip)",
                          COUNTS["k4.launches"]) + k4_demo
    split = td_times(tt, dev, X, glat, glon, fields, stats["block"])
    del X, mv
    torch.cuda.empty_cache()
    walls["members_first"], walls["members_warm"] = td_ensemble(
        tt, dev, psd, rng, gen)
    phase(31, "tenth_degree", cells=n, k4_launches=k4,
          k4_launches_per_application=k4_demo,
          **{f"{k}_s": f"{v:.2f}" for k, v in walls.items()},
          **split, gemm_peak_tflop_s=f"{F32_FLOPS_S / 1e12:.0f}",
          seconds=f"{time.perf_counter() - t0:.1f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return k4


# K5 against its twin, max over the lanes of |K5 - twin| / |twin| at the
# unit-sigma form in f32: the twin's terms bit for bit, summed in float64
# in another order (tests/test_torch_cuda_k5)
K5_RTOL = 1e-12


def fisher_z_inputs(K, B, N, live, dev, fit_sigma=False, seed=SEED + 32):
    """The fit's stacked call on the card (lengths 300-8,000 km, any
    angle, sigma 0.05-0.5 where it is fitted, displacements within 4,000
    km, 10% of the weights 0), its first `live` share of lanes (at least
    one) in the mask."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    points = torch.cat([uniform(300.0, 8000.0, K, B, 2),
                        uniform(-2 * np.pi, 2 * np.pi, K, B, 1)]
                       + [uniform(0.05, 0.5, K, B, 1)] * fit_sigma, dim=-1)
    mask = torch.zeros(B, dtype=torch.bool, device=dev)
    mask[:max(1, round(live * B))] = True
    return (points.contiguous(), uniform(-4000.0, 4000.0, B, N, 2),
            torch.arctanh(uniform(-0.2, 0.99, B, N)),
            (torch.rand((B, N), generator=g, device=dev) > 0.1).float(),
            mask)


def phase32_fisher_z(dev):
    """Phase 32: K5 at the 1-degree fit's stacked call against its plain
    twin, and its time with every lane live and with 3% of them, beside
    its bound and the twin's time. Returns its kernel record, whose
    launches the main paths' fits add (this phase's own are not)."""
    from glomargridding_tpu_torch import EllipseModel
    from glomargridding_tpu_torch.ops import optim
    from glomargridding_tpu_torch.ops.cuda import ellipse_nll
    from glomargridding_tpu_torch.utils.roofline import k5_bound

    K, B, N = 4, 2048, 4096
    model = EllipseModel(anisotropic=True, rotated=True,
                         physical_distance=True, v=1.5, unit_sigma=True)
    twin = optim.stacked_objective(model._nll_fit_z, 3)

    def k5(args):
        return ellipse_nll.fisher_z_nll(*args, v=1.5, fit_sigma=False)

    full = fisher_z_inputs(K, B, N, 1.0, dev)
    before = COUNTS["k5.launches"]
    got, want = k5(full), twin(*full)
    err = check("K5 against its twin (f32)", torch.max(
        torch.abs(got - want) / torch.abs(want)).item(), K5_RTOL)
    ms, plain_ms = cuda_time_ms(lambda: k5(full)), cuda_time_ms(
        lambda: twin(*full))
    few = fisher_z_inputs(K, B, N, 0.03, dev)
    few_ms = cuda_time_ms(lambda: k5(few))
    bound_ms, by = k5_bound(K, B, N)
    few_bound_ms, _ = k5_bound(K, int(few[-1].sum()), N)
    launched = require_launches("K5", COUNTS["k5.launches"] - before)
    phase(32, "fisher_z_kernel", K=K, lanes=B, columns=N,
          max_rel_err=f"{err:.3e}", tol=K5_RTOL, ms=f"{ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=by,
          share_of_bound=f"{bound_ms / ms:.4f}",
          live_3pct_ms=f"{few_ms:.4f}",
          live_3pct_bound_ms=f"{few_bound_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", threads=ellipse_nll.THREADS,
          launches=launched)
    return {
        "name": "ellipse_nll",
        "route": "cuda",
        "source": "glomargridding_tpu_torch/ops/cuda/csrc/ellipse_nll.cu",
        "replaces": None,
        "launches": 0,
        "max_rel_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by,
        "library_ms": None,
    }


if __name__ == "__main__":
    sys.exit(main())
