"""Smoke run of the PyTorch port (temporalgps_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final result line:
  1. torch / CUDA versions, and the card's name and power limit (nvidia-smi).
  2. Build the hand-written kernels (csrc/, one nvcc per source, side by
     side) and report the build time, ptxas register / shared-memory /
     spill counts, and the chunk counts of K1, K3 (K1's), K4, K6 (K4's), K7,
     K8 and K10 (K8's).
  3. Each value kernel (K1 phase1_aggregate, K2 phase2_starts, K3 phase3_lml)
     against its plain PyTorch version on the card, at the main path's shapes
     (Matern-5/2, D = 3, N = 1M: B = 2048 blocks of L = 489 steps), float64
     and float32. The gate is on the per-block lml partials downstream of the
     kernel: relative 1e-10 in float64, 1e-4 in float32 (the kernel and the
     plain version round and contract to FMA differently). K1's and K3's
     plain versions run in their kernels' chunk order
     (kernels.PHASE1_AGGREGATE_CHUNKS). K3 and its plain version are both
     fed K1's run aggregates; K1's block aggregates and its run aggregates
     are each held on the lml partials the plain phases compute downstream
     of them. K1-K3 are also held at phase 4's two ragged shapes, and K2
     alone at B = 1 and 5000 blocks (L = 37; more blocks than its cluster's
     2048 lanes take several rounds of its scan) on aggregates that the
     plain K1 makes; K5 and K9, which run the same cluster scan, likewise in
     phases 4 and 9.
  4. Each forward-mode kernel (K4 phase1_jvp, K5 phase2_jvp_starts, K6
     phase3_jvp_lml) against its plain version (PyTorch's forward-mode
     autodiff of the plain loops) at the training path's shapes (the same
     streams, k = 3 tangents). The gate is on the (1+k, B) lml rows
     downstream, each row scaled by its own largest entry, with the same two
     tolerances for the same reason: the kernels' tangents are written out by
     hand and contract to FMA, the plain ones come from autodiff. K4's and
     K6's plain versions run in their kernels' chunk order
     (kernels.PHASE1_JVP_CHUNKS). K6 and its plain version are both fed
     K4's run aggregates; K4's block aggregates and its run aggregates are
     each held on the rows the plain phases compute downstream of them.
     K4-K6 are also held, with the same gate, at two ragged shapes of
     B = 96 blocks: L = 37 (not a multiple of the chunk count) and L = 1
     (fewer steps than chunks), with a missing step and padding steps; K5
     alone at B = 1 and 5000 on aggregates that the plain K4 makes; and
     K4-K6 on what sum-c2's vg(p0) hands them (phase 15: k = 5 tangents,
     the same (L, B)). At sum-c2's inputs float32 is held to the float64
     plain version of the same inputs: within 1e-4, or F32_SPREAD times
     the float32 plain version's own distance from it where larger (a
     Sum's stretch tangents are rows that float32 arithmetic conditions
     worse than 1e-4); the same in phases 9 and 13.
  5. The lml path, through the public entry points:
       to_sde(GP((s2*Matern52()).stretch(sc)), ArrayStorage(float32))(
           RegularSpacing(0, 1e-3, 1_000_000), 0.1) -> logpdf
     with one missing (NaN) observation. K1-K3's launch counts must move.
     The float32 lml must be within 1e-3 relative of the float64 plain
     blocked schedule; the float64 kernel path within 1e-10 of it and, at
     N = 20k, within 1e-9 of the port's sequential engine (on the CPU); the
     gradient through the fused autograd.Function must match the plain
     schedule's (1e-10) and the sequential engine's (1e-6). One reverse-mode
     gradient at N = 1M in float32 (torch.autograd.grad through the
     Function, whose backward re-runs the plain blocked schedule): its CUDA
     event time and peak memory, finite, its distance to the forward-mode
     gradient recorded. Where the time
     of one logpdf call at N = 1M goes: torch.profiler over 10 calls
     (device busy by kernel, idle share), float32 and float64.
  6. The training path, through the public entry points:
       vg = value_and_grad_fwd_lgssm(model_fn, y); vg(p0)
     at N = 1M in float32 with k = 3 hyperparameters (log sigma^2, log
     stretch, log noise). K4-K6's launch counts must move. Value within 1e-3
     relative of the float64 run, which equals logpdf on K1-K3 (1e-10);
     float64 gradient at N = 20k within 1e-6 of the sequential engine's
     autograd gradient on the CPU and within 1e-8 of the plain forward-mode
     schedule; float32 gradient at N = 1M within 1e-3 of the float64 one per
     component, with an absolute floor of 1e-6 of the largest component
     (the components are sums over the same steps, so their float32 rounding
     shares that scale), printed beside the components' sizes; a model the
     kernels do not take (irregular times) takes the general schedule's
     forward mode on the card, K4 not launched, within 1e-8 of the CPU port
     (value and gradient, N = 64); three Adam
     steps on vg at N = 1M with finite, decreasing loss; and fit() at
     N = 20k on vg and on autograd, which must agree.
  7. Time each kernel (median of 5 batches of 10 calls) and its plain
     version (one call), the end-to-end logpdf and the end-to-end vg(p0),
     with CUDA events, float32 and float64, at N = 1M; and work out each
     kernel's bound from this run's shapes.
  8. Where the time of one vg(p0) call goes: torch.profiler over 10 calls
     (device busy by kernel, idle share) and host-clock stages.
  9. The state-emitting kernels (K7 phase3_states, K8 affine_phase1, K9
     affine_phase2_starts, K10 affine_phase3_states) against their plain
     versions at the main shapes (D = 3, N = 1M, B = 2048, L = 489), float64
     and float32. K7 takes the lml path's streams; K8-K10 take the affine
     rows of the N = 1M posterior of phase 10 (the reverse model's
     iteration view). The gate is on the state rows (K7's and K10's own,
     and those the plain phases compute downstream of K8 and K9), each row
     scaled by its largest entry: 1e-10 in float64, 1e-4 in float32, for
     the rounding and FMA reason of phase 3. K7's, K8's and K10's plain
     versions run in their kernels' chunk order (kernels.PHASE3_STATES_CHUNKS,
     AFFINE_PHASE1_CHUNKS); K10 and its plain version are both fed K8's run
     aggregates, and K8's run aggregates are held on the states downstream
     of them. K7 is also held at phase 4's two ragged shapes (a missing step
     and padding steps), K8-K10 at the same shapes on time-varying maps, and
     K9 alone at B = 1 and 5000 on aggregates that the plain K8 makes.
     K8-K10 also on the rows (F, b, 0) from a zero covariance that
     sum-c2's rand hands them (phase 15): the prior's (N = 1M) and the
     posterior's at the training inputs (2M merged steps, L = 977).
 10. The posterior path, through the public entry points:
       marginals(posterior(fx, y)(x, 0.1))   (temporalgps_torch.gp.posterior)
     for the reference's bench config c1 (GP(Matern32()), float32,
     RegularSpacing(0, 1e-3, 10_000), noise 0.1, y from default_rng(0)) and
     for the main model (phase 5's, N = 1M, one NaN) in both dtypes, and
     the prior marginals(fx). K1, K2, K7 and K8-K10 must launch on the
     posterior call, K3 must not. Gates: c1 float32 within 1e-3 relative of
     float64; float64 on the card within 1e-9 of the port's sequential
     engine on the CPU at N = 20k; at N = 1M the float32 error against
     float64 is printed beside the sizes it compares, with finite values and
     positive variances gated; a posterior at new times (2k training and 500
     prediction times, interleaved: the streamed K1, K2 and the streamed K7,
     then K8-K10) on the card within 1e-9 of the CPU in float64; cov
     refuses.
 11. Time K7-K10 as phase 7 does, each plain version once, and the
     end-to-end posterior-marginals call at c1 and at N = 1M, with each
     kernel's bound from this run's shapes.
 12. Where the time of one posterior-marginals call at N = 1M goes:
     torch.profiler over 10 calls (device busy by kernel, idle share, the
     count of other device kernels) and host-clock stages (build_lgssm,
     missing data, K1/K2/K7, the reversal of the dynamics, the affine rows,
     K8-K10, the projection).

 13. The streamed forms of K1, K3 and K7 (per-step (A, a, Q) rows) against
     their plain versions in their chunk order at irregular-c2's shapes
     (D = 3, N = 1M, B = 2048, L = 489) and at phase 4's two ragged shapes
     (the first L*B transitions of irregular-c2, identity rows on the padding
     steps), and at what sum-c2's posterior hands them (phase 15): the
     merged model's filter and the reverse model's logpdf, at the training
     inputs (2M merged steps, L = 977) and at the new times (1.1M, L =
     538); float64 and float32, gated as in phase 3 (K1's block and run
     aggregates on the lml partials downstream, K3 fed K1's runs, K7's
     states row by row); each timed as in phase 7 with its bound.
 14. irregular-c2 through the public entry points: c2's model and noise on
     N = 1M times whose steps are drawn uniform on [0.5e-3, 1.5e-3]
     (default_rng(0)), c2's y with one NaN. The float32 `logpdf` and
     posterior marginals are this slice's main path: the streamed K1, K3, K7
     with K2 and K8-K10 must launch, the constant K1, K3, K7 must not.
     logpdf, the filter, posterior marginals at the training inputs and at
     100k new times (merged N = 1.1M): finite, positive variances, float32
     lml within 1e-3 of float64; float64 at N = 20k within 1e-9 of the
     sequential engine on the CPU (lml and posterior marginals). vg(p0)
     (k = 3) on the general schedule's forward mode: float32 within 1e-3 of
     float64, and at N = 20k the float64 gradient within 1e-6 of the
     sequential engine's autograd. The D = 6 model (Matern52() +
     Matern52().stretch(3), assembled block-diagonally) at N = 100k on the
     matrix path: no kernel launched, finite; float64 at N = 2k within 1e-10
     of the CPU's matrix path. Every call timed by CUDA events (median of
     batches; vg(p0), ~20 s a call, by its gated call alone, not run
     again); torch.profiler and host stages of the irregular logpdf and the
     new-times posterior.
 15. sum-c2 through the public entry points: c2's inputs (N = 1M, one NaN)
     under 0.5 * Matern12().stretch(2.0) + Matern32().stretch(0.5) (a Sum,
     D = 3), float32 and float64. This slice's main path, each call with
     the counts set to 0 before it and read after it, held to exactly the
     launches COMPOSITE_LAUNCHES names: logpdf (K1-K3); vg(p0) with k = 5
     hyperparameters (K4-K6); posterior marginals at the training inputs
     (K1, K2, K7, K8-K10); the prior rand (K8-K10 on zero process-noise
     rows); the posterior rand at the training inputs (the merged times:
     streamed K1, K2, streamed K7, then K8-K10); the posterior logpdf at the
     training inputs and at 100k new times (that filter, then the reverse
     model's streamed K1, K2, streamed K3). The kernels line's launches are
     the float32 run's totals. Gates: finite values, positive variances,
     the same draw from the same seed; float32 within 1e-3 of float64,
     relative to the largest entry: lml, value, posterior logpdfs,
     posterior marginals, the prior and the posterior sample (on the same
     host normals, rand_with_eps; the posterior sample also within 1e-3
     of the float32 problem, its model and data as float32 stores them,
     solved in float64, and within twice that problem's distance from
     float64 where larger than 1e-3: a Sum's reversal is sensitive to the
     rounding of its transitions), the gradient as in phase 6; float64 on
     the card against the CPU port (the block engine's plain versions) at
     N = 20k within 1e-10 (the gradient 1e-8, and the posterior samples at
     two seeds of normals 1e-8: the sample takes the square root of the
     reverse model's Q, at the merged times' zero steps a difference of
     equal covariances), with the witness recorded beside them: the CPU's
     sequential-engine posterior (a Cholesky solve, where the block engine
     takes the adjugate) sampled on the same normals.
     Beside it at N = 1M: the Product Matern12() * Matern32() (D = 2),
     logpdf and rand; sum-c2 with the mean function 0.3 sin(t) (its per-step
     h moved into y), logpdf and posterior marginals; the D = 5 sum
     Matern52() + Matern32() at N = 100k on the matrix path (no kernel).
     Every call timed by CUDA events (median of 5 batches, 3 for the new
     times); each of sum-c2's seven calls under torch.profiler (device busy
     by kernel, idle share).
 16. The Fisher gradient, this slice's main path, through the public entry
     point:
       vg = value_and_grad_fisher(model_fn, y, engine="block"); vg(p0)
     for c2 (phase 6's model_fn, k = 3) at N = 1M, float32 and float64, each
     call with the counts set to 0 before it and read after it, held to
     exactly FISHER_LAUNCHES (K1-K3 for the value; K1, K2, K7 (the filter),
     K8-K10 (the posterior's latent marginals) in the backward); then with engine="parallel" (K1-K3 only) and
     sum-c2's k = 5 gradient with engine="block". Gates against the forward
     mode (value_and_grad_fwd_lgssm, K4-K6) on the same model_fn: float64
     within 1e-6 of each component plus 1e-8 of the largest, float32 within
     1e-3 of the float64 gradient plus 1e-6 of the largest (phase 6's
     gate); the value equal to logpdf's (1e-12, the same K1-K3 call);
     float64 at N = 20k on the card within 1e-10 of the CPU port and within
     1e-6 of the sequential engine's autograd. Every kernel the call
     launches is held against its plain version at the inputs the call
     hands it (the shapes of phases 3 and 9, both dtypes, the gates of
     phase 3): K1-K3 on its streams, K7 on them, K8-K10 on the rows of its
     exact (jitter-free) posterior. Each call timed by CUDA events (median
     of 5 batches of 1) beside the forward mode's; one block call under
     torch.profiler (device busy by kernel, idle share) with host stages.
 17. The other engines and the repaired matrix path at full width: c2 at N =
     1M, float32 and float64, engine="parallel" logpdf and posterior
     marginals and engine="sqrt" logpdf (no kernel launched), and the block
     logpdf with phase2="sqrt" (K1 and K3 around the square-root phase 2,
     no K2) (float64 within
     1e-9 of the block engine, float32 within 1e-3 of float64, relative to
     the largest entry); c2's posterior (reverse-ordered) conditioned again
     with engine="block" (the associative engine, no kernel), at N = 20k in
     float64 within 1e-9 of the CPU's sequential engine; the D = 5 sum at
     N = 100k on the matrix path, float32 posterior means within 1e-3 of
     float64, and float64 at N = 2k within 1e-10 of the CPU's sequential
     engine. Each call timed by CUDA events (median of 3 batches of 1).

 18. c4, exact space-time inference on the materialised grid (bench.py:594-613,
     examples/exact_space_time_inference.py), through the public entry
     points: Separable(EQ().stretch(0.7), Matern52()) on 50 points
     linspace(-3, 3) x RegularSpacing(0, 0.01, 1000), noise 0.1, y from
     default_rng(0) with one NaN; D = 150 states, 50 observations a step
     (DenseEmissions), float32 and float64. No kernel of K1-K10 takes it
     (D > 3, vector emissions): every call is held to no launch. logpdf on
     "sequential", "block", "parallel" and engine=None; the posterior
     marginals at the training inputs and at 1200 new times over the same
     span (2200 merged steps) on the three engines. Gates: float64 "block"
     and "parallel" within 1e-9 of float64 "sequential" (lml relative,
     means relative to the largest); float32 lml within 1e-3 of it. The
     float32 posterior means are NOT held within 1e-3 of float64's: no
     engine meets that, the sequential one included (~1.1e-2), because the
     float32 model's spatial jitter (1e-5 of the gram's mean diagonal
     against float64's 1e-12) moves them; that distance is printed only.
     They are held to the float32 problem (its model and data as float32
     stores them) solved in float64, within 1e-3 or F32_SPREAD times the
     float32 sequential engine's own distance, whichever is larger (the
     sequential engine, with no inverse, reads ~9.7e-4 there); finite
     values, positive variances. A prior rand (finite,
     50000 values); rand_with_eps on "block" and "parallel" against
     "sequential" on the same normals, float64, 1e-10; the autograd gradient
     of the learning objective (examples/exact_space_time_learning.py:
     kernel variance, two inverse lengthscales, noise) on "block" and
     "parallel" against "sequential", float64, 1e-8. Every call timed by
     CUDA events (median of 5 batches of 1, one for the sequential engine,
     whose calls take seconds; the first batch the call checked); the
     engine-choice table (logpdf and posterior marginals on the three
     engines at D = 30 and D = 150, both dtypes); the float32 readings with
     the LU inverse beside the program's, formed in float64 (a record, not
     a gate); torch.profiler over two calls of logpdf and of the posterior
     marginals (busy, idle share, the top device ops); the peak memory.
 19. The Kronecker-factored engine (engine="kron", space_time/kron.py),
     through the public entry points, at c4 (50 x 1000) and at the
     reference's big-space shape, c4's model on 247 points x
     RegularSpacing(0, 0.01, 100) (D = 741), float32 and float64: logpdf,
     the prior marginals, rand (n = None and n = 3, the same draws from the
     same generator seed), the posterior marginals at the training inputs
     and (c4) at 1200 new times, the float64 objective's autograd gradient;
     beside "parallel" on the same inputs (at c4 phase 18's outputs and
     times, its prior marginals apart), and at 247 x 100 beside "block" and
     "sequential" (one call). No kernel of K1-K10 launches. engine=None's
     posterior marginals and rand run at each shape and at 150 x 100
     float32 (a raise fails the phase). Of the engines named, only the
     calls in KRON_EXPECTED_RAISES may raise, and are recorded. It is
     empty: the materialised engines' float32 posterior and "parallel"'s
     float32 rand at 247 x 100 raised (a float32 filter's covariances, and
     a float32 factor of Kr (x) Q_t, not positive definite) until the
     posterior's filter ran in float64 for a float32 model
     (ops/assoc.posterior_filter_model) and samples factored in float64
     (psd.sample_factor); those calls now run and their float32 posterior
     means meet the float32 gate below.
     Gates: float64 kron within 1e-9 of float64 "parallel" (lml, prior
     marginals, posterior means; the gradient 1e-8); its posterior variances
     within 1e-8 + 1e-7 |v| elementwise (the reference's test of its kron
     smoother against its sequential one: the kron smoother keeps
     POSTERIOR_JITTER out of its backward recursion); float32 lml within
     1e-3 of float64; float32 posterior means within 1e-3 (or F32_SPREAD
     times the float32 sequential engine's distance, where that posterior
     exists: at c4 phase 18's reading) of the float32 problem solved in
     float64 by the same smoother; at 8 x 25 the card within 1e-9 of the CPU
     port (float64: logpdf, marginals, posteriors, rand_with_eps). Every
     call timed by CUDA events (median of batches of 1: 5 at 247 x 100, 3
     at c4, where kron's new times and gradient take one, as the sequential
     engine does; the script's time limit); torch.profiler over one float32
     logpdf and one posterior call at each shape (busy, idle share, top
     device ops); peak memory per shape; engine=None's choice at each shape
     (the crossover behind it: probes/torch_kron_crossover.py).
 20. c5, the pseudo-point models (space_time/pseudo_point.py, engines
     "steady", "lti" and the exact ones), through the public verbs at full
     width (50 points, 5 inducing points, D = 15): elbo and elbo + autograd
     gradient in (log s2, log sc, log noise) on "steady" at Nt = 1M (50M
     observations) and on "block" at Nt = 100k, float32 and float64; dtc and
     approx_posterior_marginals (20 new points) on "steady" at 1M; the
     ragged case of examples/approx_space_time_learning.py (float64) on
     "block" and "parallel" at Nt = 1000 and 100k: elbo with its gradient
     and approx_posterior_marginals at 25 points. No kernel of K1-K10
     launches (no TPU kernel lies on this path). Gates: the bench's
     steady-against-block cross-check at Nt = 100k in float64 (value 1e-9
     relative or F32_SPREAD times "parallel"'s distance from "block", the
     exact engines' own spread on this model, whichever is larger; gradient
     1e-6 of each component plus 1e-8 of the largest);
     float32 within 1e-3 of float64 (the elbo, the gradient as phase 6
     gates it, the approximate posterior means relative to the largest);
     the ragged block and parallel within 1e-9 (value), 1e-7 (gradient and
     means, of the largest); finite values and positive variances; at the
     bench's SMOKE sizes (5 x 2000, 3 inducing) float64 on the card within
     1e-10 of the CPU port on every engine (gradients 1e-8), and the elbo
     below the exact lml. Every call timed by CUDA events (median of 3
     batches of 1; one for the ragged 100k calls); the peak memory of the
     steady elbo and of its gradient at 1M; torch.profiler over one float32
     steady elbo + gradient at 1M (busy, idle share, top device ops); the
     float32 elbo at Nt = 100k on "parallel", "block", "lti" and "steady"
     (engine=None takes "parallel" on the card; "lti" and "steady" are
     opt-in).

The third line from the end is the card's name and power limit, the second
{"kernels": [...]} with the float32 numbers of all thirteen kernels (the
ten and the streamed forms of K1, K3, K7; launches the totals of phase 15's
and phase 16's float32 main paths, the rest from phases 7, 11 and 13), the
last {"ok": true, "device": {...}}.
"""

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
N_MAIN = 1_000_000
N_SMALL = 20_000
NAN_AT = 123_456
SEED = 0
S2, SC, NOISE = 1.0, 1.0, 0.1
D_MAIN, K_TANGENTS = 3, 3
SOURCES = {
    "phase1_aggregate": "temporalgps_torch/csrc/block_phases.cu",
    "phase2_starts": "temporalgps_torch/csrc/block_phases.cu",
    "phase3_lml": "temporalgps_torch/csrc/block_phases.cu",
    "phase1_jvp": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase2_jvp_starts": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase3_jvp_lml": "temporalgps_torch/csrc/block_phases_jvp.cu",
    "phase3_states": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase1": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase2_starts": "temporalgps_torch/csrc/block_states.cu",
    "affine_phase3_states": "temporalgps_torch/csrc/block_states.cu",
    "phase1_aggregate_streamed": "temporalgps_torch/csrc/block_phases.cu",
    "phase3_lml_streamed": "temporalgps_torch/csrc/block_phases.cu",
    "phase3_states_streamed": "temporalgps_torch/csrc/block_states.cu",
}
REPLACES = {
    "phase1_aggregate": "temporalgps_tpu/ops/pallas_kernels.py:227",
    "phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:335",
    "phase3_lml": "temporalgps_tpu/ops/pallas_kernels.py:731",
    "phase1_jvp": "temporalgps_tpu/ops/pallas_kernels.py:471",
    "phase2_jvp_starts": "temporalgps_tpu/ops/pallas_kernels.py:563",
    "phase3_jvp_lml": "temporalgps_tpu/ops/pallas_kernels.py:641",
    "phase3_states": "temporalgps_tpu/ops/pallas_kernels.py:810",
    "affine_phase1": "temporalgps_tpu/ops/pallas_kernels.py:905",
    "affine_phase2_starts": "temporalgps_tpu/ops/pallas_kernels.py:974",
    "affine_phase3_states": "temporalgps_tpu/ops/pallas_kernels.py:1017",
    # The streamed forms of K1, K3 and K7 (per-step transitions) replace the
    # same TPU kernels, which the reference's general schedule runs in XLA
    # for such models.
    "phase1_aggregate_streamed": "temporalgps_tpu/ops/pallas_kernels.py:227",
    "phase3_lml_streamed": "temporalgps_tpu/ops/pallas_kernels.py:731",
    "phase3_states_streamed": "temporalgps_tpu/ops/pallas_kernels.py:810",
}
VALUE_KERNELS = ("phase1_aggregate", "phase2_starts", "phase3_lml")
JVP_KERNELS = ("phase1_jvp", "phase2_jvp_starts", "phase3_jvp_lml")
STATE_KERNELS = ("phase3_states", "affine_phase1", "affine_phase2_starts", "affine_phase3_states")
POSTERIOR_KERNELS = ("phase1_aggregate", "phase2_starts") + STATE_KERNELS
STREAMED_KERNELS = ("phase1_aggregate_streamed", "phase3_lml_streamed", "phase3_states_streamed")
# The irregular-times posterior: streamed K1, K2, streamed K7, then K8-K10.
IRREGULAR_POSTERIOR_KERNELS = ("phase1_aggregate_streamed", "phase2_starts",
                               "phase3_states_streamed") + STATE_KERNELS[1:]
# irregular-c2: c2's model and noise on N_MAIN irregular times (time steps
# drawn uniform on [0.5e-3, 1.5e-3], default_rng(SEED)); posterior marginals
# at N_NEW new times, sorted, uniform over the span; the D = 6 model (the sum
# of Matern52() and Matern52().stretch(D6_STRETCH)) at N_D6 of the same
# times; gates against the sequential engine at N_SMALL (N_D6_SMALL for D = 6).
DT_RANGE = (0.5e-3, 1.5e-3)
N_NEW = 100_000
N_D6, N_D6_SMALL, D6_STRETCH = 100_000, 2_000, 3.0
N_C1 = 10_000
N_TRAIN_NEW, N_PRED_NEW = 2_000, 500
KERNEL_RTOL = {"float64": 1e-10, "float32": 1e-4}
# Where float32 arithmetic conditions a kernel's rows worse than KERNEL_RTOL
# (sum-c2's stretch tangents), a float32 kernel is held to the float64 plain
# version within this many times the float32 plain version's own distance:
# two float32 associations of the same rows (the kernel's and its plain
# version's) land apart by up to about twice their errors (1.9 between the
# serial and chunked plain schedules of sum-c2's tangent rows).
F32_SPREAD = 4.0
# sum-c2: c2's inputs under the kernel (s1 * Matern12()).stretch(st1) +
# (s2 * Matern32()).stretch(st2), D = 3, at SUM_HYPER = (s1, st1, s2, st2,
# noise): 0.5 * Matern12().stretch(2.0) + Matern32().stretch(0.5), noise 0.1.
# Beside it the Product Matern12() * Matern32() (D = 2), sum-c2 with the mean
# function 0.3 sin(t), and the D = 5 sum Matern52() + Matern32() at N_D5 on
# the matrix path.
SUM_HYPER = (0.5, 2.0, 1.0, 0.5, 0.1)
N_D5 = 100_000
# c4 (bench.py:594-613, examples/exact_space_time_inference.py):
# Separable(EQ().stretch(0.7), Matern52()) on C4_NS points linspace(-3, 3) x
# RegularSpacing(0, C4_DT, C4_NT), noise 0.1, y from default_rng(SEED) with a
# NaN at C4_NAN_AT (flat); D = 3 * C4_NS = 150, 50 observations a step. The
# posterior also at C4_NT_NEW new times over the same span (the example's
# extended horizon: 2200 merged steps). The engine-choice table also at
# C4_NS_SMALL points (D = 30). The learning objective's hyperparameters
# (kernel variance, inverse lengthscales in space and time, noise) at c4's.
C4_NS, C4_NT, C4_DT, C4_NT_NEW, C4_NAN_AT, C4_NS_SMALL = 50, 1000, 0.01, 1200, 4321, 10
C4_HYPER = (1.0, 0.7, 1.0, 0.1)
C4_ENGINES = ("sequential", "block", "parallel")
# The factored engine (engine="kron", phase 19) on KRON_SHAPES (points,
# times): c4, and the reference's big-space shape (bench.py:641-668, after
# its bench/lgssm.jl:69-160), c4's model on 247 points x RegularSpacing(0,
# C4_DT, 100), D = 741; y from default_rng(SEED) with a NaN at C4_NAN_AT.
# engine=None's posterior marginals and rand also at KRON_GAP (points,
# times, float32), where the materialised engines' float32 posterior raised
# before its filter ran in float64 and the speed rule alone would not take
# kron; the card against the CPU at KRON_SMALL (points, times). The calls
# that may raise: none since that repair (ROADMAP Queue 3); any raise fails
# the phase.
KRON_SHAPES = {"c4": (C4_NS, C4_NT), "big": (247, 100)}
KRON_GAP = (150, 100)
KRON_EXPECTED_RAISES = set()
KRON_SMALL = (8, 25)
# c5 (bench.py:675-751, examples/approx_space_time_learning.py): the
# pseudo-point model s2 * Separable(EQ().stretch(sc), Matern52()) on C5_NS
# points linspace(-3, 3) x RegularSpacing(0, 0.01, Nt), C5_M inducing points
# linspace(-3, 3), at log (s2, sc, noise) = C5_P0; y the standard normals of
# default_rng(SEED), drawn for C5_NT_BLOCK then for C5_NT_STEADY, as the
# bench draws them. The bench's SMOKE sizes (points, times, inducing) for
# the card against the CPU; the ragged case of the example (25-50 points at
# cumsum(0.01 + U(0, 0.01)) times, 5 inducing, 25 new points) at
# C5_RAGGED_NT times.
C5_NS, C5_M, C5_P0 = 50, 5, (0.0, 0.0, -2.3)
C5_NT_STEADY, C5_NT_BLOCK = 1_000_000, 100_000
C5_NEW = 20
C5_SMOKE = (5, 2000, 3)
C5_RAGGED_NT = (1000, 100_000)
C5_ENGINES = ("sequential", "block", "parallel", "lti", "steady")
# The calls of sum-c2's main path and the launches each must show: the
# filter (K1-K3), the forward-mode gradient (K4-K6), posterior marginals at
# the training inputs (K1, K2, K7, K8-K10), the prior rand (K8-K10 on zero
# process-noise rows), the posterior rand at the training inputs (the merged
# times are per step: streamed K1, K2, streamed K7, then K8-K10) and the
# posterior logpdf (that filter, then the reverse model's: streamed K1, K2,
# streamed K3).
COMPOSITE_LAUNCHES = {
    "logpdf": {"phase1_aggregate": 1, "phase2_starts": 1, "phase3_lml": 1},
    "value_and_grad": {"phase1_jvp": 1, "phase2_jvp_starts": 1, "phase3_jvp_lml": 1},
    "posterior_marginals": {"phase1_aggregate": 1, "phase2_starts": 1, "phase3_states": 1,
                            "affine_phase1": 1, "affine_phase2_starts": 1,
                            "affine_phase3_states": 1},
    "prior_rand": {"affine_phase1": 1, "affine_phase2_starts": 1, "affine_phase3_states": 1},
    "posterior_rand": {"phase1_aggregate_streamed": 1, "phase2_starts": 1,
                       "phase3_states_streamed": 1, "affine_phase1": 1,
                       "affine_phase2_starts": 1, "affine_phase3_states": 1},
    "posterior_logpdf": {"phase1_aggregate_streamed": 2, "phase2_starts": 2,
                         "phase3_states_streamed": 1, "phase3_lml_streamed": 1},
}
COMPOSITE_LAUNCHES["posterior_logpdf_new_times"] = COMPOSITE_LAUNCHES["posterior_logpdf"]
# The Fisher gradient's launches in one value_and_grad_fisher(..., engine="block")
# call (phase 16): the value on K1-K3; the backward's filter on K1, K2, K7,
# the latent marginals of the posterior inverted from it on K8-K10.
FISHER_LAUNCHES = {"phase1_aggregate": 2, "phase2_starts": 2, "phase3_lml": 1,
                   "phase3_states": 1, "affine_phase1": 1, "affine_phase2_starts": 1,
                   "affine_phase3_states": 1}
# engine="parallel": the value on K1-K3, the backward in tensor ops.
FISHER_PARALLEL_LAUNCHES = COMPOSITE_LAUNCHES["logpdf"]
FISHER_KERNELS = VALUE_KERNELS + STATE_KERNELS

# Ragged (L, B) of the chunked kernels (K1, K3, K4, K6, K7, K8, K10) beside
# the main shapes: L not a multiple of the chunk counts, and fewer steps than
# chunks.
RAGGED_SHAPES = ((37, 96), (1, 96))
# (L, B) at which each scan (K2, K5, K9) is held alone beside the main and
# ragged shapes: one block, and more blocks than the 2048 lanes of its
# cluster.
PHASE2_SHAPES = ((37, 1), (37, 5000))

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and arithmetic outside the tensor cores (float64 is half the float32 rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
ITEMSIZE = {"float32": 4, "float64": 8}


# ---------------------------------------------------------------------------
# Operation counts: the multiplies, adds, divides and logs of
# temporalgps_torch/csrc/lanes.cuh, line by line, as functions of D.
# ---------------------------------------------------------------------------

def _op_counts(D):
    return dict(mm=D * D * (2 * D - 1), mv=D * (2 * D - 1), dot=2 * D - 1, outer=D * D,
                madd=D * D, mscale=D * D, sym=2 * D * D, vadd=D, vscale=D,
                inv={1: 1, 2: 8, 3: 42}[D])


def flops_step_element(D):
    c = _op_counts(D)
    return (2 * c["mv"] + 2 * c["dot"] + 5 + 3 * c["vscale"] + 2 * c["outer"] + c["madd"]
            + 2 * c["mm"] + c["vadd"] + c["sym"] + c["mscale"])


def flops_step_element_tangent(D):
    c = _op_counts(D)
    return (4 * c["mv"] + 4 * c["dot"] + 11 + 6 * c["vscale"] + 6 * c["vadd"] + 4 * c["outer"]
            + 6 * c["madd"] + 4 * c["mm"] + c["sym"] + 2 * c["mscale"])


def flops_combine(D):
    c = _op_counts(D)
    return (8 * c["mm"] + 3 * c["madd"] + c["inv"] + 4 * c["mv"] + 4 * c["vadd"]
            + 2 * c["sym"])


def flops_combine_tangent(D):
    c = _op_counts(D)
    return 18 * c["mm"] + 11 * c["madd"] + 8 * c["mv"] + 8 * c["vadd"] + 2 * c["sym"]


def flops_kalman_step(D):
    c = _op_counts(D)
    return (2 * c["mv"] + 2 * c["vadd"] + 2 * c["mm"] + 2 * c["sym"] + 2 * c["madd"]
            + 2 * c["dot"] + 10 + 2 * c["vscale"] + c["outer"])


def flops_kalman_step_tangent(D):
    c = _op_counts(D)
    return (4 * c["mv"] + 6 * c["vadd"] + 4 * c["mm"] + 5 * c["madd"] + 2 * c["sym"]
            + 4 * c["dot"] + 17 + 4 * c["vscale"] + 2 * c["outer"])


def flops_kalman_state_step(D):
    """kalman_step without its lml (a log, two adds, a multiply, a divide
    and the -0.5 scale), which phase3_states does not keep."""
    return flops_kalman_step(D) - 6


def flops_affine_combine(D):
    c = _op_counts(D)
    return 3 * c["mm"] + c["mv"] + c["vadd"] + c["sym"] + c["madd"]


def flops_affine_step(D):
    c = _op_counts(D)
    return 2 * c["mm"] + c["mv"] + c["vadd"] + c["sym"] + c["madd"]


def kernel_work(name, L, B, D, k):
    """(operations, values moved) of one call: the primal once and each of
    the k tangents once; every input read once, every output written once.
    A streamed form does its kernel's work and reads KT transition values
    a step more."""
    K, SD, PK = 3 * D * D + 2 * D, D + D * D, 2 * D * D + 2 * D + 1
    KT = 2 * D * D + D
    steps = L * B
    if name.endswith("_streamed"):
        ops, values = kernel_work(name[:-len("_streamed")], L, B, D, k)
        return ops, values + KT * steps
    if name == "phase1_aggregate":
        return steps * (flops_step_element(D) + flops_combine(D)), 2 * steps + PK + K * B
    if name == "phase2_starts":
        return B * flops_combine(D), K * B + SD + SD * B
    if name == "phase3_lml":
        return steps * flops_kalman_step(D), 2 * steps + PK + SD * B + B
    if name == "phase1_jvp":
        ops = (flops_step_element(D) + flops_combine(D)
               + k * (flops_step_element_tangent(D) + flops_combine_tangent(D)))
        return steps * ops, 2 * steps + (1 + k) * (PK + 1) + (1 + k) * K * B
    if name == "phase2_jvp_starts":
        return (B * (flops_combine(D) + k * flops_combine_tangent(D)),
                (1 + k) * (K * B + SD + SD * B))
    if name == "phase3_jvp_lml":
        ops = flops_kalman_step(D) + k * flops_kalman_step_tangent(D)
        return steps * ops, 2 * steps + (1 + k) * (PK + 1) + (1 + k) * (SD * B + B)
    if name == "phase3_states":
        return steps * flops_kalman_state_step(D), 2 * steps + PK + SD * B + SD * steps
    if name == "affine_phase1":
        return steps * flops_affine_combine(D), KT * steps + KT * B
    if name == "affine_phase2_starts":
        return B * flops_affine_combine(D), KT * B + SD + SD * B
    if name == "affine_phase3_states":
        return steps * flops_affine_step(D), KT * steps + SD * B + SD * steps
    raise KeyError(name)


def kernel_bound(name, dtype_name, L, B, D, k):
    """(bound_ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak rate for the dtype."""
    ops, values = kernel_work(name, L, B, D, k)
    ops_ms = 1e3 * ops / PEAK_FLOPS[dtype_name]
    bytes_ms = 1e3 * values * ITEMSIZE[dtype_name] / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class Smoke:
    def __init__(self):
        self.failures = []
        self.record = {}

    def check(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase is reported, the later ones still run
            traceback.print_exc()
            self.failures.append(f"{name}: exception")
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def rel(a, b):
    return abs(a - b) / abs(b)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from temporalgps_torch import (RegularSpacing, fit, learning, logpdf, marginals, rand,
                                   value_and_grad_fwd_lgssm)
    from temporalgps_torch.gp import (GP, ArrayStorage, CustomMean, Matern12, Matern32,
                                      Matern52, to_sde)
    from temporalgps_torch.gp import posterior as gpost
    from temporalgps_torch.gp.lti_sde import build_lgssm
    from temporalgps_torch.models.missings import (logpdf_with_missings,
                                                   posterior_with_missings,
                                                   replace_observation_noise_cov,
                                                   transform_model_and_obs)
    from temporalgps_torch.models import emissions as em
    from temporalgps_torch.models import lgssm as tlgssm
    from temporalgps_torch.ops import block, kernels
    from temporalgps_torch.utils.fill import is_fill
    from temporalgps_torch.utils.psd import symmetrize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    # Phase 18's c4 outputs on "parallel", which phase 19 holds kron to.
    c4_parallel = {}
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    D, k = D_MAIN, K_TANGENTS

    y_np = np.random.default_rng(SEED).standard_normal(N_MAIN)
    y_np[NAN_AT] = np.nan
    y_dev = {name: torch.as_tensor(y_np, dtype=dtype, device=DEVICE)
             for name, dtype in dtypes.items()}
    p0 = torch.tensor([math.log(S2), math.log(SC), math.log(NOISE)], dtype=torch.float64,
                      device=DEVICE)

    def make_fx(dtype, N, device, s2=S2, sc=SC, noise=NOISE):
        kern = (s2 * Matern52()).stretch(sc)
        return to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, N), noise)

    def make_model_fn(dtype, N, device):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            return build_lgssm(make_fx(dtype, N, device, s2=s2, sc=sc, noise=noise))

        return model_fn

    def make_sum(dtype, N, device, hyper=SUM_HYPER, mean=None):
        """sum-c2 on c2's inputs; `hyper` (s1, st1, s2, st2, noise) may be
        tensors, for a gradient."""
        s1, st1, s2, st2, noise = hyper
        kern = (s1 * Matern12()).stretch(st1) + (s2 * Matern32()).stretch(st2)
        gp = GP(kern) if mean is None else GP(kern, mean)
        return to_sde(gp, ArrayStorage(dtype), device=device)(RegularSpacing(0.0, 1e-3, N), noise)

    def make_sum_fn(dtype, N, device):
        def model_fn(p):
            return build_lgssm(make_sum(dtype, N, device, hyper=tuple(torch.exp(p))))

        return model_fn

    p0_sum = torch.log(torch.tensor(SUM_HYPER, dtype=torch.float64, device=DEVICE))

    def events_ms(fn, reps, batches, warm_up=True):
        """Median and range over `batches` of the ms per call, each batch
        `reps` calls between two CUDA events, after one warm-up call."""
        if warm_up:
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times), min(times), max(times)

    # ---- 1. versions and card -------------------------------------------
    def phase_versions():
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
              f"count {torch.cuda.device_count()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        smoke.check(smi.returncode == 0 and bool(smi.stdout.strip()),
                    f"nvidia-smi exit {smi.returncode}")
        smoke.record["card"] = smi.stdout.strip().splitlines()[0]

    # ---- 2. build ---------------------------------------------------------
    def phase_build():
        t0 = time.perf_counter()
        path = kernels.build()
        kernels._library()
        print(f"  built {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.1f} s")
        smoke.record["chunks"] = {"phase1_aggregate": kernels.PHASE1_AGGREGATE_CHUNKS,
                                  "phase3_lml": kernels.PHASE1_AGGREGATE_CHUNKS,
                                  "phase1_jvp": kernels.PHASE1_JVP_CHUNKS,
                                  "phase3_jvp_lml": kernels.PHASE1_JVP_CHUNKS,
                                  "phase3_states": kernels.PHASE3_STATES_CHUNKS,
                                  "affine_phase1": kernels.AFFINE_PHASE1_CHUNKS,
                                  "affine_phase3_states": kernels.AFFINE_PHASE1_CHUNKS}
        print(f"  chunks a block: {smoke.record['chunks']}")
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(key in line for key in ("Compiling entry", "registers", "spill", "smem")):
                    print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- 3. value kernels against their plain versions -------------------
    def main_inputs(name):
        dtype = dtypes[name]
        model = build_lgssm(make_fx(dtype, N_MAIN, DEVICE))
        model, y, _comp = transform_model_and_obs(model, y_dev[name])
        A, a, Q, H, h, s, y, m0, P0 = block._fused_leaves(model, y)
        B = block._pallas_blocks(N_MAIN)
        y_main, s_main, _ = block._blocked_streams(y, s, B)
        packed = kernels.pack_params(A, a, Q, H, h, dtype)
        return y_main, s_main, packed, m0, symmetrize(P0)

    def record_comparison(kname, name, k_out, p_out, partials, want, label="lml-partials",
                          shape=None, part=None, truth=None, plain=None):
        """`partials` (downstream of the kernel) against `want`, row by row
        relative to each row's largest entry; recorded under the dtype's
        name, or beside it for a ragged (L, B) `shape`, for the inputs of
        another call (`shape` a label: sum-c2's) or for a `part` of the
        kernel's output other than its main one. Given `truth` (the plain
        version's rows on the same inputs in float64), a float32 comparison
        is held to it instead: `partials` within KERNEL_RTOL of it, or
        within F32_SPREAD times the distance of `plain` (the float32 plain
        version's rows) from it where that is larger; the kernel about as
        accurate as its plain version where float32 arithmetic conditions
        the rows worse than KERNEL_RTOL (a Sum's stretch tangents)."""
        finite = bool(torch.isfinite(k_out).all())
        max_abs = (k_out - p_out).abs().max().item()

        def rows_rel(a, b):
            # (A row that is zero throughout, as a sample's covariance rows
            # are, is held to zero.)
            scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(torch.finfo(b.dtype).tiny)
            return ((a - b).abs() / scale).amax(dim=-1)

        r = rows_rel(partials, want).max().item()
        key = (name if shape is None else f"{name}_{shape}" if isinstance(shape, str)
               else f"{name}_L{shape[0]}_B{shape[1]}")
        key = key if part is None else f"{key}_{part}"
        entry = smoke.record.setdefault(kname, {})[key] = {
            "max_abs_err": max_abs, f"{label.replace('-', '_')}_rel": r}
        tol = KERNEL_RTOL[name]
        if truth is None:
            smoke.check(finite and r <= tol,
                        f"{kname} {key}: finite={finite} max_abs_err={max_abs:.3e} "
                        f"{label} rel={r:.3e} (tol {tol:g})")
            return
        r_k = rows_rel(partials.double(), truth).max().item()
        r_p = rows_rel(plain.double(), truth).max().item()
        bound = max(tol, F32_SPREAD * r_p)
        entry.update(kernel_vs_f64_rel=r_k, plain_vs_f64_rel=r_p)
        smoke.check(finite and r_k <= bound,
                    f"{kname} {key}: finite={finite} {label} rel to the float64 plain version "
                    f"{r_k:.3e}, the float32 plain version's {r_p:.3e} (tol {bound:.3e}: {tol:g} "
                    f"or {F32_SPREAD} times the plain version's; kernel vs plain {r:.3e})")

    def ragged_streams(name, L, B):
        """(L, B) y and s on the card: a missing step, and padding steps at
        the end of the last block."""
        rng = np.random.default_rng(SEED + L)
        s = np.full((L, B), NOISE)
        s[min(5, L - 1), min(7, B - 1)] = 1e15
        s[max(L - 2, 0):, B - 1] = 1e15
        return (torch.as_tensor(rng.standard_normal((L, B)), dtype=dtypes[name], device=DEVICE),
                torch.as_tensor(s, dtype=dtypes[name], device=DEVICE))

    def compare_values(name, y, s, packed, m0, P0, shape=None):
        """K1-K3 against their plain versions (K1's and K3's in their chunk
        order) on the same inputs, each held on the lml partials downstream:
        K1's block aggregates and run aggregates, K2's starts, and K3 fed
        K1's run aggregates."""
        C = kernels.PHASE1_AGGREGATE_CHUNKS
        p1, p_runs = kernels.phase1_aggregate_plain(y, s, packed, D, chunks=C)
        p2 = kernels.phase2_starts_plain(p1, m0, P0, D)
        p3 = kernels.phase3_lml_plain(y, s, packed, p2, D, p_runs)
        k1, k_runs = kernels.phase1_aggregate(y, s, packed, D)
        k2 = kernels.phase2_starts(p1, m0, P0, D)
        k3 = kernels.phase3_lml(y, s, packed, p2, D, k_runs)
        torch.cuda.synchronize()
        via_k1 = kernels.phase3_lml_plain(
            y, s, packed, kernels.phase2_starts_plain(k1, m0, P0, D), D, p_runs)
        via_k_runs = kernels.phase3_lml_plain(y, s, packed, p2, D, k_runs)
        via_k2 = kernels.phase3_lml_plain(y, s, packed, k2, D, p_runs)
        record_comparison("phase1_aggregate", name, k1, p1, via_k1, p3, shape=shape)
        record_comparison("phase1_aggregate", name, k_runs, p_runs, via_k_runs, p3, shape=shape,
                          part="runs")
        record_comparison("phase2_starts", name, k2, p2, via_k2, p3, shape=shape)
        record_comparison("phase3_lml", name, k3, via_k_runs, k3, via_k_runs, shape=shape)

    def compare_phase2(name, packed, m0, P0, shape):
        """K2 alone on the aggregates that the plain K1 makes from (L, B)
        streams, held on the lml partials downstream."""
        y, s = ragged_streams(name, *shape)
        p1, p_runs = kernels.phase1_aggregate_plain(y, s, packed, D,
                                                    chunks=kernels.PHASE1_AGGREGATE_CHUNKS)
        p2 = kernels.phase2_starts_plain(p1, m0, P0, D)
        k2 = kernels.phase2_starts(p1, m0, P0, D)
        torch.cuda.synchronize()
        record_comparison("phase2_starts", name, k2, p2,
                          kernels.phase3_lml_plain(y, s, packed, k2, D, p_runs),
                          kernels.phase3_lml_plain(y, s, packed, p2, D, p_runs), shape=shape)

    def phase_compare():
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            smoke.record["shapes"] = {"L": L, "B": B, "D": D, "k": k}
            print(f"  {name}: L={L} B={B} D={D}")
            compare_values(name, y_main, s_main, packed, m0, P0)
            for shape in RAGGED_SHAPES:
                compare_values(name, *ragged_streams(name, *shape), packed, m0, P0, shape=shape)
            for shape in PHASE2_SHAPES:
                compare_phase2(name, packed, m0, P0, shape)

    # ---- 4. forward-mode kernels against their plain versions ------------
    def jvp_inputs(name, model_fn=None, p=None):
        """The streams, parameter rows and priors that vg(p) hands K4-K6
        (c2's model and p0 unless given)."""
        dtype = dtypes[name]
        model, tangents = learning._model_and_tangents(
            model_fn or make_model_fn(dtype, N_MAIN, DEVICE), p0 if p is None else p)
        model_f, y, _comp = transform_model_and_obs(model, y_dev[name])
        y_main, s_main, _ = block._blocked_streams(
            y, model_f.emis.s, block._pallas_blocks(N_MAIN))
        rows, priors = block._tangent_rows(model, tangents)
        return y_main, s_main, rows, priors

    def compare_jvp(name, y_main, s_main, rows, priors, shape=None, k=k, wide=False):
        """K4-K6 with k tangents against their plain versions (K4's and K6's
        in their chunk order) on the same inputs, each held on the lml rows
        downstream: K4's block aggregates and run aggregates, K5's starts,
        and K6 fed K4's run aggregates; with `wide`, against the plain rows
        of the same inputs in float64 (record_comparison's `truth`)."""
        C = kernels.PHASE1_JVP_CHUNKS
        truth = None
        if wide:
            wy, ws, wrows, wpriors = (t.double() for t in (y_main, s_main, rows, priors))
            w1, w_runs = kernels.phase1_jvp_plain(wy, ws, wrows, D, k, chunks=C)
            truth = kernels.phase3_jvp_lml_plain(
                wy, ws, wrows, kernels.phase2_jvp_starts_plain(w1, wpriors, D, k), D, k, w_runs)
        p1, p_runs = kernels.phase1_jvp_plain(y_main, s_main, rows, D, k, chunks=C)
        p2 = kernels.phase2_jvp_starts_plain(p1, priors, D, k)
        p3 = kernels.phase3_jvp_lml_plain(y_main, s_main, rows, p2, D, k, p_runs)
        k1, k_runs = kernels.phase1_jvp(y_main, s_main, rows, D, k)
        k2 = kernels.phase2_jvp_starts(p1, priors, D, k)
        k3 = kernels.phase3_jvp_lml(y_main, s_main, rows, p2, D, k, k_runs)
        torch.cuda.synchronize()
        via_k1 = kernels.phase3_jvp_lml_plain(
            y_main, s_main, rows, kernels.phase2_jvp_starts_plain(k1, priors, D, k), D, k, p_runs)
        via_k_runs = kernels.phase3_jvp_lml_plain(y_main, s_main, rows, p2, D, k, k_runs)
        via_k2 = kernels.phase3_jvp_lml_plain(y_main, s_main, rows, k2, D, k, p_runs)
        ref = dict(shape=shape, truth=truth, plain=p3)
        record_comparison("phase1_jvp", name, k1, p1, via_k1, p3, **ref)
        record_comparison("phase1_jvp", name, k_runs, p_runs, via_k_runs, p3, part="runs", **ref)
        record_comparison("phase2_jvp_starts", name, k2, p2, via_k2, p3, **ref)
        record_comparison("phase3_jvp_lml", name, k3, via_k_runs, k3, via_k_runs, **ref)

    def compare_phase2_jvp(name, rows, priors, shape):
        """K5 alone on the aggregates that the plain K4 makes from (L, B)
        streams, held on the lml rows downstream."""
        y, s = ragged_streams(name, *shape)
        p1, p_runs = kernels.phase1_jvp_plain(y, s, rows, D, k, chunks=kernels.PHASE1_JVP_CHUNKS)
        p2 = kernels.phase2_jvp_starts_plain(p1, priors, D, k)
        k2 = kernels.phase2_jvp_starts(p1, priors, D, k)
        torch.cuda.synchronize()
        record_comparison("phase2_jvp_starts", name, k2, p2,
                          kernels.phase3_jvp_lml_plain(y, s, rows, k2, D, k, p_runs),
                          kernels.phase3_jvp_lml_plain(y, s, rows, p2, D, k, p_runs), shape=shape)

    def phase_compare_jvp():
        for name in dtypes:
            y_main, s_main, rows, priors = jvp_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D} k={k}")
            compare_jvp(name, y_main, s_main, rows, priors)
            for shape in RAGGED_SHAPES:
                compare_jvp(name, *ragged_streams(name, *shape), rows, priors, shape=shape)
            for shape in PHASE2_SHAPES:
                compare_phase2_jvp(name, rows, priors, shape)
            # sum-c2's vg(p0): the same (L, B), k = 5 tangents; float32
            # against the float64 plain rows of the same inputs.
            inputs = jvp_inputs(name, make_sum_fn(dtypes[name], N_MAIN, DEVICE), p0_sum)
            print(f"  {name} sum-c2: L={L} B={B} D={D} k={len(p0_sum)}")
            compare_jvp(name, *inputs, shape="sum-c2", k=len(p0_sum), wide=name == "float32")

    # ---- 5. lml path -----------------------------------------------------
    def phase_main_path():
        kernels.reset_launch_counts()
        fx = make_fx(torch.float32, N_MAIN, DEVICE)
        lml32 = logpdf(fx, y_dev["float32"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record["launches"] = {name: counts[name] for name in VALUE_KERNELS}
        print(f"  float32 N={N_MAIN} lml = {lml32.item()!r}, launches {counts}")
        smoke.check(all(counts[name] >= 1 for name in VALUE_KERNELS),
                    "K1-K3 launched on the lml path")
        smoke.check(lml32.shape == () and math.isfinite(lml32.item()), "float32 lml finite scalar")

        fx64 = make_fx(torch.float64, N_MAIN, DEVICE)
        lml64_plain = logpdf(fx64, y_dev["float64"], engine="block", fused=False).item()
        lml64 = logpdf(fx64, y_dev["float64"]).item()
        print(f"  float64 N={N_MAIN} kernels {lml64!r}, plain {lml64_plain!r}")
        r32 = rel(lml32.item(), lml64_plain)
        r64 = rel(lml64, lml64_plain)
        smoke.record["main_path"] = {"lml_f32": lml32.item(), "lml_f64": lml64,
                                     "lml_f64_plain": lml64_plain,
                                     "rel_f32_vs_f64": r32, "rel_f64_vs_plain": r64}
        smoke.check(r32 <= 1e-3, f"float32 vs float64 plain rel={r32:.3e} (tol 1e-3)")
        smoke.check(r64 <= 1e-10, f"float64 kernels vs plain rel={r64:.3e} (tol 1e-10)")

        y_small = y_np[:N_SMALL]
        lml_k = logpdf(make_fx(torch.float64, N_SMALL, DEVICE), y_small).item()
        lml_seq = logpdf(make_fx(torch.float64, N_SMALL, "cpu"), y_small,
                         engine="sequential").item()
        r_seq = rel(lml_k, lml_seq)
        smoke.record["main_path"]["rel_f64_vs_sequential_20k"] = r_seq
        smoke.check(r_seq <= 1e-9,
                    f"float64 N={N_SMALL} kernels {lml_k!r} vs sequential {lml_seq!r} "
                    f"rel={r_seq:.3e} (tol 1e-9)")

        g_fused = autograd_grad(DEVICE, engine="block", fused=True)
        g_plain = autograd_grad(DEVICE, engine="block", fused=False)
        g_seq = autograd_grad("cpu", engine="sequential")
        r_plain = ((g_fused - g_plain).abs().max() / g_plain.abs().max()).item()
        r_gseq = ((g_fused.cpu() - g_seq).abs().max() / g_seq.abs().max()).item()
        print(f"  grad fused {g_fused.tolist()}, sequential {g_seq.tolist()}")
        smoke.record["main_path"]["grad_rel_vs_plain"] = r_plain
        smoke.record["main_path"]["grad_rel_vs_sequential"] = r_gseq
        smoke.check(r_plain <= 1e-10, f"grad fused vs plain rel={r_plain:.3e} (tol 1e-10)")
        smoke.check(r_gseq <= 1e-6, f"grad fused vs sequential rel={r_gseq:.3e} (tol 1e-6)")

        # The reverse-mode gradient at N = 1M in float32: _LogpdfFused's
        # backward re-runs the plain blocked schedule under autograd. One
        # call, CUDA events, and the peak memory above what was allocated.
        p = p0.detach().clone().requires_grad_()
        s2, sc, noise = torch.exp(p)
        fx_g = make_fx(torch.float32, N_MAIN, DEVICE, s2=s2, sc=sc, noise=noise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        (g_rev,) = torch.autograd.grad(logpdf(fx_g, y_dev["float32"]), p)
        end.record()
        end.synchronize()
        rev = {"ms": start.elapsed_time(end),
               "peak_bytes": torch.cuda.max_memory_allocated() - base, "grad": g_rev.tolist()}
        _, g_fwd = value_and_grad_fwd_lgssm(make_model_fn(torch.float32, N_MAIN, DEVICE),
                                            y_dev["float32"])(p0)
        rev["rel_vs_forward_mode"] = ((g_rev - g_fwd).abs().max() / g_fwd.abs().max()).item()
        smoke.record["main_path"]["reverse_mode_grad_1M_f32"] = rev
        print(f"  reverse-mode gradient N={N_MAIN} float32: {json.dumps(rev)}", flush=True)
        smoke.check(finite(g_rev), "reverse-mode gradient at N=1M float32 finite")

        for name, dtype in dtypes.items():
            fx_p, y_p = make_fx(dtype, N_MAIN, DEVICE), y_dev[name]
            summary = call_profile(lambda: logpdf(fx_p, y_p), VALUE_KERNELS)
            smoke.record.setdefault("profile_logpdf", {})[name] = summary
            print(f"  logpdf profile {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K1-K3 on the device")

    @functools.lru_cache(maxsize=None)
    def autograd_grad(device, **kw):
        """Reverse-mode gradient of the float64 lml at N = 20k."""
        p = p0.detach().to(device).requires_grad_()
        s2, sc, noise = torch.exp(p)
        fx_g = make_fx(torch.float64, N_SMALL, device, s2=s2, sc=sc, noise=noise)
        (g,) = torch.autograd.grad(logpdf(fx_g, y_np[:N_SMALL], **kw), p)
        return g

    # ---- 6. training path ------------------------------------------------
    def phase_training():
        rec = smoke.record["training"] = {}
        vg32 = value_and_grad_fwd_lgssm(make_model_fn(torch.float32, N_MAIN, DEVICE), y_np)
        kernels.reset_launch_counts()
        v32, g32 = vg32(p0)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record["launches"].update({name: counts[name] for name in JVP_KERNELS})
        print(f"  float32 N={N_MAIN} value {v32.item()!r} grad {g32.tolist()}, launches {counts}")
        smoke.check(all(counts[name] >= 1 for name in JVP_KERNELS),
                    "K4-K6 launched on the training path")
        smoke.check(v32.shape == () and g32.shape == (k,)
                    and bool(torch.isfinite(g32).all()) and math.isfinite(v32.item()),
                    "float32 value and gradient finite, shapes () and (k,)")

        v64, g64 = value_and_grad_fwd_lgssm(
            make_model_fn(torch.float64, N_MAIN, DEVICE), y_np)(p0)
        lml64 = logpdf(make_fx(torch.float64, N_MAIN, DEVICE), y_dev["float64"]).item()
        print(f"  float64 N={N_MAIN} value {v64.item()!r} grad {g64.tolist()}")
        r_v32 = rel(v32.item(), v64.item())
        r_v64 = rel(v64.item(), lml64)
        # Each component is a sum over the same N steps, so float32 rounding
        # scales with the largest one: the floor is 1e-6 of it, the gate
        # 1e-3 of the component itself.
        floor = 1e-6 * g64.abs().max().item()
        excess = ((g32 - g64).abs() - (1e-3 * g64.abs() + floor)).max().item()
        rec.update({"value_f32": v32.item(), "value_f64": v64.item(), "grad_f32": g32.tolist(),
                    "grad_f64": g64.tolist(), "rel_value_f32_vs_f64": r_v32,
                    "rel_value_f64_vs_logpdf": r_v64,
                    "grad_f32_abs_err": (g32 - g64).abs().tolist(),
                    "grad_f32_rel_per_component": ((g32 - g64).abs() / g64.abs()).tolist(),
                    "grad_floor": floor,
                    "grad_floor_over_smallest": floor / g64.abs().min().item()})
        smoke.check(r_v32 <= 1e-3, f"float32 value vs float64 rel={r_v32:.3e} (tol 1e-3)")
        smoke.check(r_v64 <= 1e-10, f"float64 value vs logpdf on K1-K3 rel={r_v64:.3e} (tol 1e-10)")
        smoke.check(excess <= 0.0,
                    f"float32 grad vs float64: |g64|={g64.abs().tolist()} "
                    f"abs err={rec['grad_f32_abs_err']} "
                    f"rel={rec['grad_f32_rel_per_component']} (tol 1e-3 relative + {floor:.3g} "
                    f"absolute, {rec['grad_floor_over_smallest']:.2e} of the smallest component)")

        # A model K4-K6 do not take (irregular times) takes the forward mode
        # of the general block schedule on the card, and matches the CPU port.
        times = torch.linspace(0.0, 4.0, 64, dtype=torch.float64) ** 1.5

        def irregular_on(device):
            def irregular_fn(p):
                s2, sc, noise = torch.exp(p)
                kern = (s2 * Matern52()).stretch(sc)
                return build_lgssm(to_sde(GP(kern), device=device)(times.to(device), noise))

            return irregular_fn

        before = kernels.launch_counts()["phase1_jvp"]
        v_i, g_i = value_and_grad_fwd_lgssm(irregular_on(DEVICE), y_np[:64])(p0)
        v_c, g_c = value_and_grad_fwd_lgssm(irregular_on("cpu"), y_np[:64])(p0.cpu())
        r_i = max(rel(v_i.item(), v_c.item()),
                  ((g_i.cpu() - g_c).abs().max() / g_c.abs().max()).item())
        smoke.check(kernels.launch_counts()["phase1_jvp"] == before and r_i <= 1e-8,
                    f"irregular times: the general schedule's forward mode on the card, K4 not "
                    f"launched, value and gradient vs the CPU port rel={r_i:.3e} (tol 1e-8)")

        y_small = y_np[:N_SMALL]
        _, g_k = value_and_grad_fwd_lgssm(make_model_fn(torch.float64, N_SMALL, DEVICE), y_small)(p0)
        _, g_p = value_and_grad_fwd_lgssm(
            make_model_fn(torch.float64, N_SMALL, "cpu"), y_small)(p0.cpu())
        g_seq = autograd_grad("cpu", engine="sequential")
        r_p = ((g_k.cpu() - g_p).abs().max() / g_p.abs().max()).item()
        r_s = ((g_k.cpu() - g_seq).abs().max() / g_seq.abs().max()).item()
        rec.update({"grad_20k_rel_vs_plain_jvp": r_p, "grad_20k_rel_vs_sequential": r_s})
        smoke.check(r_p <= 1e-8,
                    f"float64 N={N_SMALL} grad vs plain forward-mode schedule rel={r_p:.3e} (tol 1e-8)")
        smoke.check(r_s <= 1e-6,
                    f"float64 N={N_SMALL} grad vs sequential autograd rel={r_s:.3e} (tol 1e-6)")

        p = p0.clone()
        opt = torch.optim.Adam([p], lr=1e-1)
        losses = []
        for _ in range(3):
            value, grad = vg32(p)
            p.grad = -grad
            opt.step()
            losses.append(-value.item())
        print(f"  three Adam steps at N={N_MAIN} float32: losses {losses}, p {p.tolist()}")
        rec["adam_losses"] = losses
        smoke.check(all(math.isfinite(x) for x in losses) and losses[0] > losses[1] > losses[2],
                    "three Adam steps: finite, decreasing loss")

        vg_small = value_and_grad_fwd_lgssm(make_model_fn(torch.float64, N_SMALL, DEVICE), y_small)

        def neg_vg(params):
            value, grad = vg_small(params)
            return -value, -grad

        def objective(params):
            s2, sc, noise = torch.exp(params)
            return -logpdf(make_fx(torch.float64, N_SMALL, DEVICE, s2=s2, sc=sc, noise=noise),
                           y_small)

        fit_fwd = fit(neg_vg, p0, steps=3, has_grad=True)
        fit_rev = fit(objective, p0, steps=3)
        r_fit = ((fit_fwd.losses - fit_rev.losses).abs() / fit_rev.losses.abs()).max().item()
        print(f"  fit at N={N_SMALL} float64: losses {fit_fwd.losses.tolist()}, "
              f"params {fit_fwd.params.tolist()}")
        rec.update({"fit_losses": fit_fwd.losses.tolist(), "fit_rel_fwd_vs_autograd": r_fit})
        smoke.check(bool((fit_fwd.losses[1:] < fit_fwd.losses[:-1]).all()) and r_fit <= 1e-8,
                    f"fit on vg decreases and matches fit on autograd rel={r_fit:.3e} (tol 1e-8)")

    # ---- 7. timing -------------------------------------------------------
    def phase_timing():
        for name, dtype in dtypes.items():
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            _, _, rows, priors = jvp_inputs(name)
            L, B = y_main.shape
            comps, runs = kernels.phase1_aggregate(y_main, s_main, packed, D)
            starts = kernels.phase2_starts(comps, m0, P0, D)
            jcomps, jruns = kernels.phase1_jvp(y_main, s_main, rows, D, k)
            jstarts = kernels.phase2_jvp_starts(jcomps, priors, D, k)
            fx = make_fx(dtype, N_MAIN, DEVICE)
            vg = value_and_grad_fwd_lgssm(make_model_fn(dtype, N_MAIN, DEVICE), y_dev[name])
            calls = {
                "phase1_aggregate": (
                    lambda: kernels.phase1_aggregate(y_main, s_main, packed, D),
                    lambda: kernels.phase1_aggregate_plain(
                        y_main, s_main, packed, D, chunks=kernels.PHASE1_AGGREGATE_CHUNKS)),
                "phase2_starts": (
                    lambda: kernels.phase2_starts(comps, m0, P0, D),
                    lambda: kernels.phase2_starts_plain(comps, m0, P0, D)),
                "phase3_lml": (
                    lambda: kernels.phase3_lml(y_main, s_main, packed, starts, D, runs),
                    lambda: kernels.phase3_lml_plain(y_main, s_main, packed, starts, D, runs)),
                "phase1_jvp": (
                    lambda: kernels.phase1_jvp(y_main, s_main, rows, D, k),
                    lambda: kernels.phase1_jvp_plain(y_main, s_main, rows, D, k,
                                                     chunks=kernels.PHASE1_JVP_CHUNKS)),
                "phase2_jvp_starts": (
                    lambda: kernels.phase2_jvp_starts(jcomps, priors, D, k),
                    lambda: kernels.phase2_jvp_starts_plain(jcomps, priors, D, k)),
                "phase3_jvp_lml": (
                    lambda: kernels.phase3_jvp_lml(y_main, s_main, rows, jstarts, D, k, jruns),
                    lambda: kernels.phase3_jvp_lml_plain(y_main, s_main, rows, jstarts, D, k,
                                                         jruns)),
                "end_to_end_logpdf": (
                    lambda: logpdf(fx, y_dev[name]),
                    lambda: logpdf(fx, y_dev[name], engine="block", fused=False)),
                "end_to_end_value_and_grad": (lambda: vg(p0), None),
            }
            time_calls(name, calls, L, B)

    def time_calls(name, calls, L, B):
        """Median of 5 batches of 10 calls of each kernel call, one call of
        its plain version, and the kernel's bound at (L, B)."""
        for kname, (kernel_call, plain_call) in calls.items():
            with torch.no_grad():
                k_ms = events_ms(kernel_call, reps=10, batches=5)
                # The plain versions ran in the compare phases: one call, no warm-up.
                p_ms = (events_ms(plain_call, reps=1, batches=1, warm_up=False)
                        if plain_call else (None,))
            entry = smoke.record.setdefault(kname, {}).setdefault(name, {})
            entry.update({"ms": k_ms[0], "ms_range": k_ms[1:], "plain_ms": p_ms[0]})
            line = f"  {name} {kname}: {k_ms[0]!r} ms (range {k_ms[1]!r}..{k_ms[2]!r})"
            if plain_call:
                line += f", plain {p_ms[0]!r} ms (one call)"
            if kname in REPLACES:
                bound_ms, bound_by = kernel_bound(kname, name, L, B, D, k)
                entry.update({"bound_ms": bound_ms, "bound_by": bound_by})
                line += f", bound {bound_ms!r} ms by {bound_by}"
            print(line, flush=True)

    # ---- 8. where the time of one vg(p0) call goes -----------------------
    def device_profile(call, calls):
        """({kernel name: device us per call}, device kernels launched) of
        `calls` calls under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        device_us = {}
        n_device_ops = 0
        for event in prof.key_averages():
            us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            is_kernel = "Kernel" in str(getattr(event, "device_type", "")) or \
                str(getattr(event, "device_type", "")).endswith("CUDA")
            if us and is_kernel:
                device_us[event.key] = us / calls
                n_device_ops += event.count
        return device_us, n_device_ops

    def kernel_us(device_us, short):
        """Device us of the kernel `<short>_kernel`, mangled or not: its name
        must not run on from a longer one (phase3_states_kernel within
        affine_phase3_states_kernel)."""
        pattern = re.compile(rf"(?<![A-Za-z_]){short}_kernel")
        return sum(us for key, us in device_us.items() if pattern.search(key))

    def call_profile(call, shorts, calls=10):
        """One call's ms (CUDA events, median of 3 batches of `calls`), and
        under torch.profiler over `calls` calls: device busy us, idle share,
        the us of the kernels `shorts` and of the rest, device ops a call."""
        call_ms = events_ms(call, reps=calls, batches=3)[0]
        device_us, n_device_ops = device_profile(call, calls)
        busy_us = sum(device_us.values())
        ours = {short: kernel_us(device_us, short) for short in shorts}
        return {"call_ms": call_ms, "device_busy_us": busy_us,
                "idle_share": 1.0 - busy_us / (1e3 * call_ms) if busy_us else None,
                "kernel_us": ours, "other_device_us": busy_us - sum(ours.values()),
                "device_ops_per_call": n_device_ops / calls}

    def stage_ms(fn, reps=20):
        """Median host-clock ms of fn() between two synchronises, and its output."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    def phase_profile():
        for name, dtype in dtypes.items():
            model_fn = make_model_fn(dtype, N_MAIN, DEVICE)
            vg = value_and_grad_fwd_lgssm(model_fn, y_dev[name])
            summary = call_profile(lambda: vg(p0), JVP_KERNELS)
            build_ms, _ = stage_ms(lambda: model_fn(p0))
            tangents_ms, (model, tangents) = stage_ms(
                lambda: learning._model_and_tangents(model_fn, p0))
            fwd_ms, _ = stage_ms(
                lambda: block.logpdf_fwd_grad(model, y_dev[name], tangents))
            rows_ms, _ = stage_ms(lambda: block._tangent_rows(model, tangents))
            summary["host_stage_ms"] = {"model_fn": build_ms, "jacfwd_model_and_tangents": tangents_ms,
                                        "logpdf_fwd_grad": fwd_ms, "of_which_tangent_rows": rows_ms}
            smoke.record.setdefault("profile", {})[name] = summary
            print(f"  {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K4-K6 on the device")


    # ---- 9-12. smoothing and prediction ------------------------------------
    y_c1 = np.random.default_rng(SEED).standard_normal(N_C1)

    def make_c1(dtype, device):
        """The reference's bench config c1: GP(Matern32()), noise 0.1."""
        return to_sde(GP(Matern32()), ArrayStorage(dtype), device=device)(
            RegularSpacing(0.0, 1e-3, N_C1), NOISE)

    def posterior_marginals(fx, y, engine=None):
        """The public call: the posterior's marginals at the training inputs
        with prediction noise 0.1."""
        return gpost.marginals(gpost.posterior(fx, y)(fx.x, NOISE), engine=engine)

    def affine_inputs(name):
        """The affine rows, initial mean and covariance that the N = 1M
        posterior's marginals hand K8-K10 (the reverse iteration view)."""
        post = posterior_with_missings(build_lgssm(make_fx(dtypes[name], N_MAIN, DEVICE)),
                                       y_dev[name])
        params = block._affine_comps_iteration(post, block._pallas_blocks(N_MAIN))
        return params, post.trans.x0.mean, symmetrize(post.trans.x0.cov)

    def rel_max(a, b):
        """Largest error relative to the largest entry of the reference b
        (0 where both are all zeros, as the prior's means are)."""
        scale = b.abs().max().clamp_min(torch.finfo(torch.float64).tiny)
        return ((a - b).abs().max() / scale).item()

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def ragged_affine(name, L, B):
        """Time-varying stable maps (KT, L, B), an initial state, on the card."""
        rng = np.random.default_rng(SEED + L)
        F = np.eye(D) * 0.95 + 0.02 * rng.standard_normal((L, B, D, D))
        G = 0.1 * rng.standard_normal((L, B, D, D))
        C = np.einsum("lbij,lbkj->lbik", G, G)
        rows = np.concatenate([F.reshape(L, B, D * D), 0.1 * rng.standard_normal((L, B, D)),
                               C.reshape(L, B, D * D)], axis=-1)
        to = lambda x: torch.as_tensor(x, dtype=dtypes[name], device=DEVICE).contiguous()
        return to(rows.transpose(2, 0, 1)), to(0.1 * rng.standard_normal(D)), to(np.eye(D))

    # ---- 9. state-emitting kernels against their plain versions ---------
    def compare_affine(name, params, m0, P0, shape=None, wide=False):
        """K8-K10 against their plain versions (K8's and K10's in their chunk
        order) on the same inputs, each held on the state rows downstream:
        K8's block aggregates and run aggregates, K9's starts, and K10 fed
        K8's run aggregates; with `wide`, against the plain rows of the same
        inputs in float64 (record_comparison's `truth`)."""
        rows = lambda t: t.reshape(D + D * D, -1)
        truth = None
        if wide:
            wp, wm0, wP0 = (t.double() for t in (params, m0, P0))
            w8, w_runs = kernels.affine_phase1_plain(wp, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
            truth = rows(kernels.affine_phase3_states_plain(
                wp, kernels.affine_phase2_starts_plain(w8, wm0, wP0, D), D, w_runs))
        p8, p_runs = kernels.affine_phase1_plain(params, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
        p9 = kernels.affine_phase2_starts_plain(p8, m0, P0, D)
        p10 = kernels.affine_phase3_states_plain(params, p9, D, p_runs)
        k8, k_runs = kernels.affine_phase1(params, D)
        k9 = kernels.affine_phase2_starts(p8, m0, P0, D)
        k10 = kernels.affine_phase3_states(params, p9, D, k_runs)
        torch.cuda.synchronize()
        via_k8 = kernels.affine_phase3_states_plain(
            params, kernels.affine_phase2_starts_plain(k8, m0, P0, D), D, p_runs)
        via_k_runs = kernels.affine_phase3_states_plain(params, p9, D, k_runs)
        via_k9 = kernels.affine_phase3_states_plain(params, k9, D, p_runs)
        ref = dict(shape=shape, truth=truth, plain=rows(p10))
        record_comparison("affine_phase1", name, k8, p8, rows(via_k8), rows(p10), "states", **ref)
        record_comparison("affine_phase1", name, k_runs, p_runs, rows(via_k_runs), rows(p10),
                          "states", part="runs", **ref)
        record_comparison("affine_phase2_starts", name, k9, p9, rows(via_k9), rows(p10),
                          "states", **ref)
        record_comparison("affine_phase3_states", name, k10, via_k_runs, rows(k10),
                          rows(via_k_runs), "states", **ref)

    def compare_affine_phase2(name, shape):
        """K9 alone on the aggregates that the plain K8 makes from (KT, L, B)
        time-varying maps, held on the state rows downstream."""
        rows = lambda t: t.reshape(D + D * D, -1)
        params, m0, P0 = ragged_affine(name, *shape)
        p8, p_runs = kernels.affine_phase1_plain(params, D, chunks=kernels.AFFINE_PHASE1_CHUNKS)
        p9 = kernels.affine_phase2_starts_plain(p8, m0, P0, D)
        k9 = kernels.affine_phase2_starts(p8, m0, P0, D)
        torch.cuda.synchronize()
        record_comparison("affine_phase2_starts", name, k9, p9,
                          rows(kernels.affine_phase3_states_plain(params, k9, D, p_runs)),
                          rows(kernels.affine_phase3_states_plain(params, p9, D, p_runs)),
                          "states", shape=shape)

    def phase_compare_states():
        rows = lambda t: t.reshape(D + D * D, -1)
        for name in dtypes:
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            starts = kernels.phase2_starts(
                kernels.phase1_aggregate(y_main, s_main, packed, D)[0], m0, P0, D)
            params, am0, aP0 = affine_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D}, affine rows {tuple(params.shape)}")
            p7 = kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                             chunks=kernels.PHASE3_STATES_CHUNKS)
            k7 = kernels.phase3_states(y_main, s_main, packed, starts, D)
            torch.cuda.synchronize()
            record_comparison("phase3_states", name, k7, p7, rows(k7), rows(p7), "states")
            compare_affine(name, params, am0, aP0)
            for shape in RAGGED_SHAPES:
                y_r, s_r = ragged_streams(name, *shape)
                r_starts = kernels.phase2_starts_plain(
                    kernels.phase1_aggregate_plain(y_r, s_r, packed, D,
                                                   chunks=kernels.PHASE1_AGGREGATE_CHUNKS)[0],
                    m0, P0, D)
                p7 = kernels.phase3_states_plain(y_r, s_r, packed, r_starts, D,
                                                 chunks=kernels.PHASE3_STATES_CHUNKS)
                k7 = kernels.phase3_states(y_r, s_r, packed, r_starts, D)
                torch.cuda.synchronize()
                record_comparison("phase3_states", name, k7, p7, rows(k7), rows(p7), "states",
                                  shape=shape)
                compare_affine(name, *ragged_affine(name, *shape), shape=shape)
            for shape in PHASE2_SHAPES:
                compare_affine_phase2(name, shape)
            # sum-c2's prior rand (N = 1M) and posterior rand at the training
            # inputs (2M merged steps): the rows (F, b, 0) from a zero
            # covariance; float32 against the float64 plain rows of the same
            # inputs.
            for label, model in (
                    ("prior-rand", build_lgssm(make_sum(dtypes[name], N_MAIN, DEVICE))),
                    ("posterior-rand", sum_c2_merged(name, "training")[1][0])):
                params, x_init, zero = rand_rows(model, dtypes[name])
                print(f"  {name} sum-c2 {label}: affine rows {tuple(params.shape)}")
                compare_affine(name, params, x_init, zero, shape=f"sum-c2-{label}",
                               wide=name == "float32")

    # ---- 10. posterior path ----------------------------------------------
    def phase_posterior():
        rec = smoke.record["posterior"] = {}
        # The main path: float32 first, its launch counts are the kernels line's.
        main = {}
        for name in ("float32", "float64"):
            fx = make_fx(dtypes[name], N_MAIN, DEVICE)
            kernels.reset_launch_counts()
            m, v = posterior_marginals(fx, y_dev[name])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if name == "float32":
                smoke.record["launches"].update({kn: counts[kn] for kn in STATE_KERNELS})
            smoke.check(all(counts[kn] >= 1 for kn in POSTERIOR_KERNELS)
                        and counts["phase3_lml"] == 0,
                        f"{name} N={N_MAIN} posterior marginals: K1, K2, K7-K10 launched, "
                        f"K3 not: {counts}")
            smoke.check(m.shape == v.shape == (N_MAIN,) and finite(m, v) and bool((v > 0).all()),
                        f"{name} N={N_MAIN}: finite means, positive variances, shape ({N_MAIN},)")
            main[name] = (m.double(), v.double())
        (m32, v32), (m64, v64) = main["float32"], main["float64"]
        rec["main_f32_vs_f64"] = {
            "means_rel": rel_max(m32, m64), "vars_rel": rel_max(v32, v64),
            "means_abs": (m32 - m64).abs().max().item(), "vars_abs": (v32 - v64).abs().max().item(),
            "max_abs_mean": m64.abs().max().item(), "var_min": v64.min().item(),
            "var_max": v64.max().item()}
        print(f"  N={N_MAIN} D={D} float32 vs float64: {json.dumps(rec['main_f32_vs_f64'])}")

        c1 = {}
        for name in ("float32", "float64"):
            fx = make_c1(dtypes[name], DEVICE)
            kernels.reset_launch_counts()
            m, v = posterior_marginals(fx, y_c1)
            pm, pv = marginals(fx)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            smoke.check(all(counts[kn] >= 1 for kn in POSTERIOR_KERNELS) and finite(m, v, pm, pv),
                        f"c1 {name}: kernels launched {counts}, finite")
            c1[name] = [t.double() for t in (m, v, pm, pv)]
        r_c1 = [rel_max(a, b) for a, b in zip(c1["float32"], c1["float64"])]
        rec["c1_f32_vs_f64_rel"] = dict(zip(("post_means", "post_vars", "prior_means",
                                             "prior_vars"), r_c1))
        smoke.check(max(r_c1) <= 1e-3,
                    f"c1 float32 vs float64 rel {rec['c1_f32_vs_f64_rel']} (tol 1e-3)")

        y_small = y_np[:N_SMALL]
        m_k, v_k = posterior_marginals(make_fx(torch.float64, N_SMALL, DEVICE), y_small)
        m_s, v_s = posterior_marginals(make_fx(torch.float64, N_SMALL, "cpu"), y_small)
        r_seq = max(rel_max(m_k.cpu(), m_s), rel_max(v_k.cpu(), v_s))
        rec["f64_20k_rel_vs_sequential"] = r_seq
        smoke.check(r_seq <= 1e-9,
                    f"float64 N={N_SMALL} card vs sequential engine on the CPU rel={r_seq:.3e} "
                    f"(tol 1e-9)")

        x_pr = np.sort(np.random.default_rng(SEED + 1).uniform(0.0, 1e-3 * N_TRAIN_NEW,
                                                               N_PRED_NEW))

        def new_times(device):
            fx = make_fx(torch.float64, N_TRAIN_NEW, device)
            fp = gpost.posterior(fx, y_np[:N_TRAIN_NEW])
            return gpost.marginals(fp(x_pr, 0.05))

        kernels.reset_launch_counts()
        m_n, v_n = new_times(DEVICE)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        m_c, v_c = new_times("cpu")
        r_new = max(rel_max(m_n.cpu(), m_c), rel_max(v_n.cpu(), v_c))
        rec["new_times_rel_vs_cpu"] = r_new
        smoke.check(all(counts[kn] == 1 for kn in IRREGULAR_POSTERIOR_KERNELS)
                    and counts["phase3_states"] == 0 and m_n.shape == (N_PRED_NEW,),
                    f"new times: streamed K1, K2, streamed K7, then K8-K10: {counts}")
        smoke.check(r_new <= 1e-9,
                    f"float64 new times ({N_TRAIN_NEW} + {N_PRED_NEW}) card vs CPU "
                    f"rel={r_new:.3e} (tol 1e-9)")
        try:
            gpost.cov(gpost.posterior(make_c1(torch.float64, DEVICE), y_c1)(RegularSpacing(0.0, 1e-3, 4)))
            refused = False
        except NotImplementedError:
            refused = True
        smoke.check(refused, "the dense posterior covariance is refused")

    # ---- 11. timing of the posterior path --------------------------------
    def phase_timing_states():
        for name, dtype in dtypes.items():
            y_main, s_main, packed, m0, P0 = main_inputs(name)
            L, B = y_main.shape
            starts = kernels.phase2_starts(
                kernels.phase1_aggregate(y_main, s_main, packed, D)[0], m0, P0, D)
            params, am0, aP0 = affine_inputs(name)
            agg, aruns = kernels.affine_phase1(params, D)
            astarts = kernels.affine_phase2_starts(agg, am0, aP0, D)
            fx, fx_c1 = make_fx(dtype, N_MAIN, DEVICE), make_c1(dtype, DEVICE)
            calls = {
                "phase3_states": (
                    lambda: kernels.phase3_states(y_main, s_main, packed, starts, D),
                    lambda: kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                                        chunks=kernels.PHASE3_STATES_CHUNKS)),
                "affine_phase1": (
                    lambda: kernels.affine_phase1(params, D),
                    lambda: kernels.affine_phase1_plain(params, D,
                                                        chunks=kernels.AFFINE_PHASE1_CHUNKS)),
                "affine_phase2_starts": (
                    lambda: kernels.affine_phase2_starts(agg, am0, aP0, D),
                    lambda: kernels.affine_phase2_starts_plain(agg, am0, aP0, D)),
                "affine_phase3_states": (
                    lambda: kernels.affine_phase3_states(params, astarts, D, aruns),
                    lambda: kernels.affine_phase3_states_plain(params, astarts, D, aruns)),
                "end_to_end_posterior_marginals": (
                    lambda: posterior_marginals(fx, y_dev[name]), None),
                "end_to_end_posterior_marginals_c1": (
                    lambda: posterior_marginals(fx_c1, y_c1), None),
            }
            time_calls(name, calls, L, B)

    # ---- 12. where the time of one posterior-marginals call goes ---------
    def phase_profile_posterior():
        for name, dtype in dtypes.items():
            fx = make_fx(dtype, N_MAIN, DEVICE)
            y = y_dev[name]
            summary = call_profile(lambda: posterior_marginals(fx, y), POSTERIOR_KERNELS)
            B = block._pallas_blocks(N_MAIN)
            build_ms, model = stage_ms(lambda: build_lgssm(fx))
            missing_ms, (model_f, y_f, _) = stage_ms(lambda: transform_model_and_obs(model, y))
            filter_ms, xf = stage_ms(lambda: block._filter_state_comps(model_f, y_f, None, None))
            reversal_ms, (post, _) = stage_ms(lambda: block._reversed_model(model_f, xf))
            post = replace_observation_noise_cov(post, fx.noise.value.expand(N_MAIN))
            rows_ms, params = stage_ms(lambda: block._affine_comps_iteration(post, B))
            affine_ms, comps = stage_ms(lambda: block._affine_states(post, params, None))
            project_ms, _ = stage_ms(lambda: block._project(post, comps))
            summary["other_device_ops_per_call"] = (summary["device_ops_per_call"]
                                                    - len(POSTERIOR_KERNELS))
            summary["host_stage_ms"] = {"build_lgssm": build_ms, "missing_data": missing_ms,
                                        "K1_K2_K7_filter_states": filter_ms,
                                        "reversal_of_dynamics": reversal_ms,
                                        "affine_comps_iteration": rows_ms, "K8_K9_K10": affine_ms,
                                        "projection": project_ms}
            smoke.record.setdefault("profile_posterior", {})[name] = summary
            print(f"  {name}: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name}: the profiler saw K1, K2, K7-K10 on the device")

    # ---- 13-14. per-step transitions: irregular times, D > 3 ----------------
    times_np = np.cumsum(np.random.default_rng(SEED).uniform(*DT_RANGE, N_MAIN))
    x_new = np.sort(np.random.default_rng(SEED + 2).uniform(times_np[0], times_np[-1], N_NEW))

    def make_irregular(dtype, N, device, s2=S2, sc=SC, noise=NOISE):
        """irregular-c2: c2's model on the first N irregular times."""
        kern = (s2 * Matern52()).stretch(sc)
        return to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            torch.as_tensor(times_np[:N], device=device), noise)

    def make_irregular_fn(dtype, N, device):
        def model_fn(p):
            s2, sc, noise = torch.exp(p)
            return build_lgssm(make_irregular(dtype, N, device, s2=s2, sc=sc, noise=noise))

        return model_fn

    def streams_of(model, y):
        """The streams, emission row, (KT, L, B) transition rows and prior
        that the streamed K1, K3 and K7 take for a model of per-step
        transitions and its observations: the missing ones filled in, a
        reverse-ordered model through its forward view, as logpdf and the
        posterior's filter hand them."""
        model, y, _comp = transform_model_and_obs(model, y)
        model, y = block._forward_view(model, y)
        A, a, Q, H, h, s, y, m0, P0 = block._fused_leaves(model, y)
        B = block._pallas_blocks(len(model))
        y_main, s_main, _ = block._blocked_streams(y, s, B)
        return (y_main, s_main, block._emission_params(H, h, model.dtype),
                block._rows_blocked(A, a, Q, B), m0, symmetrize(P0))

    def streamed_inputs(name):
        """What logpdf hands the streamed K1 and K3 for irregular-c2."""
        return streams_of(build_lgssm(make_irregular(dtypes[name], N_MAIN, DEVICE)), y_dev[name])

    def ragged_rows(name, L, B):
        """(KT, L, B) rows: the first L*B transitions of irregular-c2, with
        identity rows on the padding steps ragged_streams marks."""
        model = build_lgssm(make_irregular(dtypes[name], L * B, DEVICE))
        rows = block._affine_comps_iteration(model, B)
        ident = torch.eye(D, dtype=rows.dtype, device=DEVICE).reshape(-1)
        rows[:, max(L - 2, 0):, B - 1] = 0.0
        rows[:D * D, max(L - 2, 0):, B - 1] = ident[:, None]
        return rows

    def compare_streamed(name, y, s, packed, rows, m0, P0, shape=None, wide=False):
        """The streamed K1, K3, K7 against their plain versions in their
        chunk order on the same inputs: K1's block and run aggregates held
        on the lml partials downstream, K3 fed K1's run aggregates, K7's
        states row by row; with `wide`, against the plain lml partials and
        states of the same inputs in float64 (record_comparison's
        `truth`)."""
        st_rows = lambda t: t.reshape(D + D * D, -1)
        truth = (None, None)
        if wide:
            wy, ws, wpk, wrows, wm0, wP0 = (t.double() for t in (y, s, packed, rows, m0, P0))
            w1, w_runs = kernels.phase1_aggregate_plain(
                wy, ws, wpk, D, chunks=kernels.PHASE1_AGGREGATE_CHUNKS, trans_rows=wrows)
            w2 = kernels.phase2_starts_plain(w1, wm0, wP0, D)
            truth = (kernels.phase3_lml_plain(wy, ws, wpk, w2, D, w_runs, trans_rows=wrows),
                     st_rows(kernels.phase3_states_plain(
                         wy, ws, wpk, w2, D, chunks=kernels.PHASE3_STATES_CHUNKS,
                         trans_rows=wrows)))
        p1, p_runs = kernels.phase1_aggregate_plain(
            y, s, packed, D, chunks=kernels.PHASE1_AGGREGATE_CHUNKS, trans_rows=rows)
        p2 = kernels.phase2_starts_plain(p1, m0, P0, D)
        p3 = kernels.phase3_lml_plain(y, s, packed, p2, D, p_runs, trans_rows=rows)
        p7 = kernels.phase3_states_plain(y, s, packed, p2, D, chunks=kernels.PHASE3_STATES_CHUNKS,
                                         trans_rows=rows)
        k1, k_runs = kernels.phase1_aggregate_streamed(y, s, packed, D, rows)
        k3 = kernels.phase3_lml_streamed(y, s, packed, p2, D, k_runs, rows)
        k7 = kernels.phase3_states_streamed(y, s, packed, p2, D, rows)
        torch.cuda.synchronize()
        via_k1 = kernels.phase3_lml_plain(
            y, s, packed, kernels.phase2_starts_plain(k1, m0, P0, D), D, p_runs, trans_rows=rows)
        via_k_runs = kernels.phase3_lml_plain(y, s, packed, p2, D, k_runs, trans_rows=rows)
        lml = dict(shape=shape, truth=truth[0], plain=p3)
        record_comparison("phase1_aggregate_streamed", name, k1, p1, via_k1, p3, **lml)
        record_comparison("phase1_aggregate_streamed", name, k_runs, p_runs, via_k_runs, p3,
                          part="runs", **lml)
        record_comparison("phase3_lml_streamed", name, k3, via_k_runs, k3, via_k_runs, **lml)
        record_comparison("phase3_states_streamed", name, k7, p7, st_rows(k7), st_rows(p7),
                          "states", shape=shape, truth=truth[1], plain=st_rows(p7))

    # ---- 13. streamed kernels against their plain versions; their times ----
    def phase_compare_streamed():
        for name in dtypes:
            y_main, s_main, packed, rows, m0, P0 = streamed_inputs(name)
            L, B = y_main.shape
            print(f"  {name}: L={L} B={B} D={D}, transition rows {tuple(rows.shape)}")
            compare_streamed(name, y_main, s_main, packed, rows, m0, P0)
            for shape in RAGGED_SHAPES:
                compare_streamed(name, *ragged_streams(name, *shape), packed,
                                 ragged_rows(name, *shape), m0, P0, shape=shape)
            comps, runs = kernels.phase1_aggregate_streamed(y_main, s_main, packed, D, rows)
            starts = kernels.phase2_starts(comps, m0, P0, D)
            C1, C7 = kernels.PHASE1_AGGREGATE_CHUNKS, kernels.PHASE3_STATES_CHUNKS
            time_calls(name, {
                "phase1_aggregate_streamed": (
                    lambda: kernels.phase1_aggregate_streamed(y_main, s_main, packed, D, rows),
                    lambda: kernels.phase1_aggregate_plain(y_main, s_main, packed, D, chunks=C1,
                                                           trans_rows=rows)),
                "phase3_lml_streamed": (
                    lambda: kernels.phase3_lml_streamed(y_main, s_main, packed, starts, D, runs,
                                                        rows),
                    lambda: kernels.phase3_lml_plain(y_main, s_main, packed, starts, D, runs,
                                                     trans_rows=rows)),
                "phase3_states_streamed": (
                    lambda: kernels.phase3_states_streamed(y_main, s_main, packed, starts, D,
                                                           rows),
                    lambda: kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                                        chunks=C7, trans_rows=rows)),
            }, L, B)
        # sum-c2's posterior at the training inputs (2M merged steps) and at
        # the new times (1.1M): the merged model's filter and the reverse
        # model's logpdf, as its main path hands them over; float32 against
        # the float64 plain rows of the same inputs.
        for name in dtypes:
            for at in ("training", "new"):
                for label, (model, y) in zip(("filter", "logpdf"), sum_c2_merged(name, at)):
                    inputs = streams_of(model, y)
                    print(f"  {name} sum-c2 {at} {label}: (L, B) {tuple(inputs[0].shape)}")
                    compare_streamed(name, *inputs, shape=f"sum-c2-{at}-{label}",
                                     wide=name == "float32")

    # ---- 14. irregular-c2 and the D = 6 model ----------------------------
    def make_d6(dtype, N, device):
        """The D = 6 model: Matern52() + Matern52().stretch(D6_STRETCH) on the
        first N irregular times, noise NOISE."""
        kern = Matern52() + Matern52().stretch(D6_STRETCH)
        return build_lgssm(to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            torch.as_tensor(times_np[:N], device=device), NOISE))

    def irregular_stages(cname, fx, y):
        """Host-clock ms of the stages of the irregular logpdf or of the
        posterior at new times (medians of 5, between synchronises)."""
        from temporalgps_torch.models import lgssm as tlgssm

        if cname == "irregular_logpdf":
            build_ms, model = stage_ms(lambda: build_lgssm(fx), reps=5)
            missing_ms, (model_f, y_f, _) = stage_ms(
                lambda: transform_model_and_obs(model, y), reps=5)
            B = block._pallas_blocks(len(model_f))
            rows_ms, _ = stage_ms(lambda: block._rows_blocked(
                *block._fused_leaves(model_f, y_f)[:3], B), reps=5)
            kernels_ms, _ = stage_ms(lambda: block.logpdf(model_f, y_f), reps=5)
            return {"build_lgssm": build_ms, "missing_data": missing_ms,
                    "transition_rows": rows_ms, "block_logpdf_with_rows": kernels_ms}
        fp = gpost.posterior(fx, y)
        fxp = fp(x_new, NOISE)
        merge_ms, (x_s, noise_all, y_all, _, pr_idx) = stage_ms(
            lambda: gpost._build_inference_data(fp, x_new), reps=5)
        build_ms, model = stage_ms(lambda: build_lgssm(fp.prior(x_s, noise_all)), reps=5)
        missing_ms, (model_f, y_f, _) = stage_ms(
            lambda: transform_model_and_obs(model, y_all), reps=5)
        filter_ms, xf = stage_ms(lambda: block._filter_state_comps(model_f, y_f, None, None),
                                 reps=5)
        reversal_ms, (post, _) = stage_ms(lambda: block._reversed_model(model_f, xf), reps=5)
        marg_ms, _ = stage_ms(lambda: tlgssm.marginals_diag(post), reps=5)
        return {"host_merge_and_sort": merge_ms, "build_lgssm": build_ms,
                "missing_data": missing_ms, "K1s_K2_K7s_filter_states": filter_ms,
                "reversal_of_dynamics": reversal_ms, "marginals_K8_K10_and_rows": marg_ms,
                "x_new_points": len(fxp.x)}

    def phase_irregular():
        from temporalgps_torch.models import lgssm as tlgssm

        rec = smoke.record["irregular"] = {}

        def new_times(fx, y):
            return gpost.marginals(gpost.posterior(fx, y)(x_new, NOISE))

        def filter_states(fx, y):
            model_f, y_f, _ = transform_model_and_obs(build_lgssm(fx), y)
            return tlgssm.filter_(model_f, y_f)

        # The main path of this slice: float32, its launch counts are the kernels line's.
        fx32 = make_irregular(torch.float32, N_MAIN, DEVICE)
        kernels.reset_launch_counts()
        lml32 = logpdf(fx32, y_dev["float32"])
        m32, v32 = posterior_marginals(fx32, y_dev["float32"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        smoke.record.setdefault("launches", {}).update({kn: counts[kn] for kn in STREAMED_KERNELS})
        smoke.check(all(counts[kn] >= 1 for kn in STREAMED_KERNELS + IRREGULAR_POSTERIOR_KERNELS)
                    and counts["phase1_aggregate"] == counts["phase3_lml"] == 0
                    and counts["phase3_states"] == 0,
                    f"irregular-c2 float32 logpdf and posterior marginals: streamed K1, K3, K7, "
                    f"K2, K8-K10 launched, the constant K1, K3, K7 not: {counts}")
        outs = {}
        for name, dtype in dtypes.items():
            fx = fx32 if name == "float32" else make_irregular(dtype, N_MAIN, DEVICE)
            y = y_dev[name]
            xf = filter_states(fx, y)
            m_n, v_n = new_times(fx, y)
            outs[name] = [t.double() for t in (
                logpdf(fx, y).reshape(1), xf.mean, xf.cov, *posterior_marginals(fx, y), m_n, v_n)]
            smoke.check(finite(*outs[name]) and bool((outs[name][4] > 0).all())
                        and bool((outs[name][6] > 0).all()) and m_n.shape == (N_NEW,),
                        f"irregular-c2 {name}: finite lml, states and marginals, positive "
                        f"variances, {N_NEW} new-time marginals")
        labels = ("lml", "filter_means", "filter_covs", "post_means", "post_vars",
                  "new_means", "new_vars")
        r32 = {lab: rel_max(a, b) for lab, a, b in zip(labels, outs["float32"], outs["float64"])}
        rec["f32_vs_f64_rel"] = r32
        smoke.check(r32["lml"] <= 1e-3, f"irregular-c2 float32 vs float64 lml rel={r32['lml']:.3e} "
                    f"(tol 1e-3); the rest, relative to the largest entry: {json.dumps(r32)}")

        # At N_SMALL, float64 on the card against the sequential engine on the CPU.
        y_small = y_np[:N_SMALL]
        fx_k, fx_c = (make_irregular(torch.float64, N_SMALL, dev) for dev in (DEVICE, "cpu"))
        got = [logpdf(fx_k, y_small).reshape(1), *posterior_marginals(fx_k, y_small)]
        want = [logpdf(fx_c, y_small, engine="sequential").reshape(1),
                *gpost.marginals(gpost.posterior(fx_c, y_small)(fx_c.x, NOISE),
                                 engine="sequential")]
        r_seq = max(rel_max(g.cpu(), w) for g, w in zip(got, want))
        rec["f64_20k_rel_vs_sequential"] = r_seq
        smoke.check(r_seq <= 1e-9, f"irregular float64 N={N_SMALL} lml and posterior marginals "
                    f"vs the sequential engine rel={r_seq:.3e} (tol 1e-9)")

        # The gradient on the general schedule's forward mode (k = 3).
        # Each call takes ~20 s: the gated calls are the timed ones (CUDA
        # events, one call each), not run again below.
        vg = {name: value_and_grad_fwd_lgssm(make_irregular_fn(dtypes[name], N_MAIN, DEVICE),
                                             y_dev[name]) for name in dtypes}
        vg_out = {}
        for name in dtypes:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            vg_out[name] = vg[name](p0)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            rec.setdefault("ms", {}).setdefault(name, {})["irregular_value_and_grad"] = ms
            print(f"  {name} irregular_value_and_grad: {ms!r} ms (1 call)", flush=True)
        (v32g, g32), (v64g, g64) = vg_out["float32"], vg_out["float64"]
        r_vg = max(rel(v32g.item(), v64g.item()),
                   ((g32.double() - g64).abs().max() / g64.abs().max()).item())
        rec.update({"vg_f32": [v32g.item(), g32.tolist()], "vg_f64": [v64g.item(), g64.tolist()],
                    "vg_f32_vs_f64_rel": r_vg})
        smoke.check(finite(g32, g64) and r_vg <= 1e-3,
                    f"irregular vg(p0) float32 vs float64 rel={r_vg:.3e} (tol 1e-3), "
                    f"grad {g64.tolist()}")
        vg_small = value_and_grad_fwd_lgssm(make_irregular_fn(torch.float64, N_SMALL, DEVICE),
                                            y_small)
        _, g_k = vg_small(p0)
        p = p0.detach().cpu().requires_grad_()
        s2, sc, noise = torch.exp(p)
        (g_s,) = torch.autograd.grad(logpdf(make_irregular(torch.float64, N_SMALL, "cpu", s2=s2,
                                                           sc=sc, noise=noise), y_small,
                                            engine="sequential"), p)
        r_g = ((g_k.cpu() - g_s).abs().max() / g_s.abs().max()).item()
        rec["vg_20k_rel_vs_sequential"] = r_g
        smoke.check(r_g <= 1e-6, f"irregular float64 N={N_SMALL} vg gradient vs the sequential "
                    f"engine's autograd rel={r_g:.3e} (tol 1e-6)")

        # The D = 6 model on the matrix path (for the record; gated on the
        # sequential engine at N_D6_SMALL).
        y6 = y_np[:N_D6]
        d6 = {name: make_d6(dtypes[name], N_D6, DEVICE) for name in dtypes}
        kernels.reset_launch_counts()
        lml6 = {name: logpdf_with_missings(d6[name], y_dev[name][:N_D6]).item() for name in dtypes}
        lat6 = {name: tlgssm.latent_marginals(d6[name]) for name in dtypes}
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        r6 = rel(lml6["float32"], lml6["float64"])
        rec["d6"] = {"lml": lml6, "lml_f32_vs_f64_rel": r6,
                     "latent_f32_vs_f64_rel": [rel_max(lat6["float32"].mean.double(),
                                                       lat6["float64"].mean),
                                               rel_max(lat6["float32"].cov.double(),
                                                       lat6["float64"].cov)]}
        smoke.check(all(n == 0 for n in counts.values()) and math.isfinite(lml6["float64"])
                    and finite(lat6["float64"].mean, lat6["float64"].cov),
                    f"D = 6 at N={N_D6}: the matrix path (no kernel launched), finite; float32 "
                    f"vs float64 lml rel={r6:.3e}, latent {rec['d6']['latent_f32_vs_f64_rel']}")
        # The matrix path is held to the same path on the CPU (held to the
        # reference there by tests/test_torch_general.py); its distance to
        # the sequential engine is recorded (phase 17 gates the D = 5 sum's
        # on it).
        small_k, small_c = (make_d6(torch.float64, N_D6_SMALL, dev) for dev in (DEVICE, "cpu"))
        y6s = torch.as_tensor(y_np[:N_D6_SMALL])

        def d6_small(model, y, engine):
            lat = tlgssm.latent_marginals(model, engine=engine)
            return [logpdf_with_missings(model, y, engine=engine).reshape(1), lat.mean, lat.cov]

        got = d6_small(small_k, y6s.to(DEVICE), None)
        r6b = max(rel_max(g.cpu(), w) for g, w in zip(got, d6_small(small_c, y6s, "block")))
        r6s = max(rel_max(g.cpu(), w) for g, w in zip(got, d6_small(small_c, y6s, "sequential")))
        rec["d6"].update({"f64_small_rel_vs_cpu_matrix_path": r6b,
                          "f64_small_rel_vs_sequential": r6s})
        smoke.check(r6b <= 1e-10, f"D = 6 float64 N={N_D6_SMALL} lml and latent marginals on the "
                    f"card vs the CPU's matrix path rel={r6b:.3e} (tol 1e-10); vs the "
                    f"sequential engine rel={r6s:.3e}")

        # Times (CUDA events, median of batches) and where the time goes.
        for name, dtype in dtypes.items():
            fx = fx32 if name == "float32" else make_irregular(dtype, N_MAIN, DEVICE)
            y = y_dev[name]
            y6n = y_dev[name][:N_D6]
            calls = {
                "irregular_logpdf": (lambda: logpdf(fx, y), 5, 10),
                "irregular_filter": (lambda: filter_states(fx, y), 5, 5),
                "irregular_posterior_marginals": (lambda: posterior_marginals(fx, y), 5, 5),
                "irregular_posterior_new_times": (lambda: new_times(fx, y), 3, 3),
                "d6_logpdf": (lambda: logpdf_with_missings(d6[name], y6n), 3, 3),
                "d6_latent_marginals": (lambda: tlgssm.latent_marginals(d6[name]), 3, 3),
            }
            for cname, (call, batches, reps) in calls.items():
                with torch.no_grad():
                    ms = events_ms(call, reps=reps, batches=batches)
                rec.setdefault("ms", {}).setdefault(name, {})[cname] = ms[0]
                print(f"  {name} {cname}: {ms[0]!r} ms (range {ms[1]!r}..{ms[2]!r}, "
                      f"{batches} batches of {reps})", flush=True)
            for cname, call, shorts in (
                    ("irregular_logpdf", lambda: logpdf(fx, y), VALUE_KERNELS),
                    ("irregular_posterior_new_times", lambda: new_times(fx, y),
                     POSTERIOR_KERNELS)):
                summary = call_profile(call, shorts, calls=3)
                summary["host_stage_ms"] = irregular_stages(cname, fx, y)
                rec.setdefault("profile", {}).setdefault(name, {})[cname] = summary
                print(f"  {name} {cname} profile: {json.dumps(summary)}", flush=True)
                smoke.check(summary["device_busy_us"] > 0
                            and all(us > 0 for us in summary["kernel_us"].values()),
                            f"{name} {cname}: the profiler saw the streamed kernels")

    # ---- 15. sum-c2: composite models, sampling, the posterior's logpdf ----
    def make_other(kind, dtype, N, device):
        """The Product (D = 2), sum-c2 with its mean function, or the D = 5
        sum, on c2's inputs."""
        if kind == "product":
            gp = GP(Matern12() * Matern32())
        elif kind == "d5":
            gp = GP(Matern52() + Matern32())
        else:
            return make_sum(dtype, N, device, mean=CustomMean(lambda t: 0.3 * torch.sin(t)))
        return to_sde(gp, ArrayStorage(dtype), device=device)(RegularSpacing(0.0, 1e-3, N), NOISE)

    x_new_sum = np.sort(np.random.default_rng(SEED + 3).uniform(0.0, 1e-3 * (N_MAIN - 1), N_NEW))
    y_pr_np = np.random.default_rng(SEED + 4).standard_normal(N_MAIN)

    def composite_calls(dtype, N, device, y, gen, engine=None):
        """The public calls of sum-c2's main path at N on `device`, each a
        function of nothing (COMPOSITE_LAUNCHES names them); `engine="block"`
        runs the kernels' plain versions on the CPU."""
        fx = make_sum(dtype, N, device)
        vg = value_and_grad_fwd_lgssm(make_sum_fn(dtype, N, device), y)
        fp = gpost.posterior(fx, y)
        fxp_tr, fxp_new = fp(fx.x, NOISE), fp(x_new_sum[x_new_sum < 1e-3 * (N - 1)], NOISE)
        y_pr = torch.as_tensor(y_pr_np[:N], dtype=dtype, device=device)
        y_new = torch.as_tensor(y_pr_np[:len(fxp_new.x)], dtype=dtype, device=device)
        p = p0_sum.to(device)
        return {
            "logpdf": lambda: logpdf(fx, y, engine=engine),
            "value_and_grad": lambda: vg(p),
            "posterior_marginals": lambda: posterior_marginals(fx, y, engine),
            "prior_rand": lambda: rand(gen.manual_seed(SEED), fx, engine=engine),
            "posterior_rand": lambda: gpost.rand(gen.manual_seed(SEED), fxp_tr, engine=engine),
            "posterior_logpdf": lambda: gpost.logpdf(fxp_tr, y_pr, engine=engine),
            "posterior_logpdf_new_times": lambda: gpost.logpdf(fxp_new, y_new, engine=engine),
        }, fx, fxp_tr

    def eps_for(model, dtype, device, seed=SEED + 5):
        """Standard normals (eps_t, eps_e, x_init) for rand_with_eps, drawn
        once on the host in float64."""
        rng = np.random.default_rng(seed)
        N_, D_ = len(model), model.latent_dim
        return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (rng.standard_normal((N_, D_)), rng.standard_normal(N_),
                               rng.standard_normal(D_)))

    def rand_rows(model, dtype):
        """The (KT, L, B) rows (F, b, 0), the initial state and its zero
        covariance that the block rand hands K8-K10 on eps_for's normals."""
        eps_t, _eps_e, x_init = eps_for(model, dtype, DEVICE)
        F, b = block._sample_maps(model, eps_t)
        rows = block._rows_blocked(F, b, torch.zeros_like(F), block._blocks(model, None, True))
        return rows, x_init, x_init.new_zeros(D, D)

    def sum_c2_merged(name, at):
        """sum-c2's posterior at N_MAIN at the training inputs or at the new
        times, as its main path builds it: ((the merged forward model, its
        observations), which the posterior's filter takes; (the
        reverse-ordered posterior LGSSM, the observations its logpdf scores,
        NaN at the training indices))."""
        dtype = dtypes[name]
        fx = make_sum(dtype, N_MAIN, DEVICE)
        fp = gpost.posterior(fx, y_dev[name])
        fxp = fp(fx.x if at == "training" else x_new_sum, NOISE)
        x_sorted, noise_all, y_all, _tr_idx, _pr_idx = gpost._build_inference_data(fp, fxp.x)
        post, idx = gpost._merged_posterior(fxp, None)
        y_full = torch.full((len(post),), float("nan"), dtype=dtype, device=DEVICE)
        y_full[idx] = torch.as_tensor(y_pr_np[:len(idx)], dtype=dtype, device=DEVICE)
        return (build_lgssm(fp.prior(x_sorted, noise_all)), y_all), (post, y_full)

    def sum_samples(fx, fxp, dtype, device, seed=SEED + 5, engine="block"):
        """Prior and posterior (training inputs) samples of sum-c2 on the
        same host normals, through rand_with_eps on `engine` (the block
        engine: the kernels on the card, their plain versions on the CPU)."""
        from temporalgps_torch.models import lgssm as tlgssm

        prior = build_lgssm(fx)
        post, idx = gpost._merged_posterior(fxp, engine)
        return (tlgssm.rand_with_eps(prior, *eps_for(prior, dtype, device, seed), engine=engine),
                tlgssm.rand_with_eps(post, *eps_for(post, dtype, device, seed),
                                     engine=engine)[idx])

    def widened(model):
        """`model` with every leaf cast to float64, its values kept: a
        float32 problem, as float32 stores it, solved in float64 (any
        emission container)."""
        wide = lambda leaf: (dataclasses.replace(leaf, value=leaf.value.double())
                             if is_fill(leaf) else leaf.double())
        t = model.trans
        x0 = dataclasses.replace(t.x0, mean=t.x0.mean.double(), cov=t.x0.cov.double())
        return dataclasses.replace(
            model, trans=dataclasses.replace(t, As=wide(t.As), offs=wide(t.offs),
                                             Qs=wide(t.Qs), x0=x0),
            emis=em.map_leaves(wide, model.emis))

    def float32_problem_sample(fxp):
        """The posterior sample at the training inputs on eps_for's normals
        of the float32 posterior `fxp`, its model and data as float32 stores
        them, solved in float64: the float32 sample's reference with the
        storage set apart (a Sum's reversal is sensitive to the rounding of
        its transitions: the split of the observed sum between its
        components)."""
        from temporalgps_torch.models import lgssm as tlgssm

        fp = fxp.f
        x_sorted, noise_all, y_all, _tr_idx, pr_idx = gpost._build_inference_data(fp, fxp.x)
        post = replace_observation_noise_cov(
            posterior_with_missings(widened(build_lgssm(fp.prior(x_sorted, noise_all))),
                                    y_all.double()),
            gpost._pred_noise_full(pr_idx, len(x_sorted), fxp.noise, torch.float64, DEVICE))
        return tlgssm.rand_with_eps(post, *eps_for(post, torch.float64, DEVICE),
                                    engine="block")[torch.as_tensor(pr_idx, device=DEVICE)]

    def phase_composite():
        from temporalgps_torch.models import lgssm as tlgssm

        rec = smoke.record["composite"] = {}
        gen = torch.Generator(device=DEVICE)
        outs, fxp_by = {}, {}
        for name, dtype in dtypes.items():
            calls, fx, fxp_tr = composite_calls(dtype, N_MAIN, DEVICE, y_dev[name], gen)
            fxp_by[name] = fxp_tr
            results, launches = {}, {}
            for cname, call in calls.items():
                kernels.reset_launch_counts()
                results[cname] = call()
                torch.cuda.synchronize()
                counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
                launches[cname] = counts
                smoke.check(counts == COMPOSITE_LAUNCHES[cname],
                            f"sum-c2 {name} {cname}: launches {counts} "
                            f"(want {COMPOSITE_LAUNCHES[cname]})")
            rec.setdefault("launches", {})[name] = launches
            if name == "float32":
                # This slice's main path: the kernels line reads its launches.
                total = {}
                for counts in launches.values():
                    for kn, n in counts.items():
                        total[kn] = total.get(kn, 0) + n
                smoke.record["launches"] = {kn: total.get(kn, 0) for kn in REPLACES}
            vals = {c: results[c] for c in ("logpdf", "posterior_logpdf",
                                             "posterior_logpdf_new_times")}
            vals["value"], vals["grad"] = results["value_and_grad"]
            vals["post_means"], vals["post_vars"] = results["posterior_marginals"]
            vals["prior_sample"], vals["posterior_sample"] = sum_samples(fx, fxp_tr, dtype, DEVICE)
            outs[name] = {key: t.double() for key, t in vals.items()}
            for cname in ("prior_rand", "posterior_rand"):
                draw = results[cname]
                smoke.check(draw.shape == (N_MAIN,) and finite(draw)
                            and torch.equal(draw, calls[cname]()),
                            f"sum-c2 {name} {cname}: ({N_MAIN},), finite, the same draw from "
                            f"the same seed")
            smoke.check(all(finite(t) for t in outs[name].values())
                        and bool((outs[name]["post_vars"] > 0).all()),
                        f"sum-c2 {name}: finite values, positive posterior variances")
        r32 = {key: rel_max(outs["float32"][key], outs["float64"][key]) for key in outs["float64"]}
        rec["f32_vs_f64_rel"] = r32
        # The posterior sample: the float32 problem (its model and data as
        # float32 stores them) solved in float64 sets the storage apart. The
        # float32 sample within 1e-3 of it, and within 1e-3 of the float64
        # sample or twice that problem's own distance from it.
        reference = float32_problem_sample(fxp_by["float32"])
        storage = rel_max(reference, outs["float64"]["posterior_sample"])
        arithmetic = rel_max(outs["float32"]["posterior_sample"], reference)
        rec["posterior_sample_f32_storage_rel"] = storage
        rec["posterior_sample_f32_arithmetic_rel"] = arithmetic
        tol32 = {"posterior_sample": max(1e-3, 2 * storage)}
        smoke.check(all(r <= tol32.get(key, 1e-3) for key, r in r32.items() if key != "grad")
                    and arithmetic <= 1e-3,
                    f"sum-c2 float32 vs float64, relative to the largest entry (tol 1e-3; the "
                    f"posterior sample {tol32['posterior_sample']:.3e}, twice the distance of "
                    f"the float32 problem solved in float64, {storage:.3e}; the float32 "
                    f"sample from that, {arithmetic:.3e}, tol 1e-3): {json.dumps(r32)}")
        # The gradient as phase 6 gates it: 1e-3 of each component, with a
        # floor of 1e-6 of the largest one.
        g32, g64 = outs["float32"]["grad"], outs["float64"]["grad"]
        floor = 1e-6 * g64.abs().max().item()
        excess = ((g32 - g64).abs() - (1e-3 * g64.abs() + floor)).max().item()
        rec["grad_f32_rel_per_component"] = ((g32 - g64).abs() / g64.abs()).tolist()
        smoke.check(excess <= 0.0,
                    f"sum-c2 float32 grad vs float64: |g64|={g64.abs().tolist()} "
                    f"rel={rec['grad_f32_rel_per_component']} (tol 1e-3 relative + "
                    f"{floor:.3g} absolute)")

        # float64 on the card against the CPU port (the block engine: its
        # plain versions) at N_SMALL.
        y_small = y_np[:N_SMALL]
        got, want = ({}, {})
        for device, out in ((DEVICE, got), ("cpu", want)):
            calls, fx, fxp_tr = composite_calls(torch.float64, N_SMALL, device,
                                                torch.as_tensor(y_small, device=device),
                                                torch.Generator(device=device), "block")
            out["logpdf"] = calls["logpdf"]().reshape(1)
            value, out["grad"] = calls["value_and_grad"]()
            out["value"] = value.reshape(1)
            out["post_means"], out["post_vars"] = calls["posterior_marginals"]()
            out["posterior_logpdf"] = calls["posterior_logpdf"]().reshape(1)
            out["posterior_logpdf_new_times"] = calls["posterior_logpdf_new_times"]().reshape(1)
            out["prior_sample"], out["posterior_sample"] = sum_samples(fx, fxp_tr, torch.float64,
                                                                       device)
            out["posterior_sample_seed2"] = sum_samples(fx, fxp_tr, torch.float64, device,
                                                        seed=SEED + 6)[1]
            if device == "cpu":
                # The witness: the sequential engine's posterior (the
                # reverse dynamics by a Cholesky solve, not the adjugate)
                # sampled on the same normals.
                witness = sum_samples(fx, fxp_tr, torch.float64, device, engine="sequential")[1]
            for kind in ("product", "custom_mean"):
                fx_o = make_other(kind, torch.float64, N_SMALL, device)
                out[f"{kind}_logpdf"] = logpdf(fx_o, y_small, engine="block").reshape(1)
            fx_m = make_other("custom_mean", torch.float64, N_SMALL, device)
            out["custom_mean_post_means"], out["custom_mean_post_vars"] = \
                posterior_marginals(fx_m, y_small, "block")
            prod = build_lgssm(make_other("product", torch.float64, N_SMALL, device))
            out["product_sample"] = tlgssm.rand_with_eps(prod, *eps_for(prod, torch.float64,
                                                                        device), engine="block")
        # The posterior samples are held at 1e-8: at the merged times' zero
        # steps the reverse model's Q is a difference of equal covariances,
        # which one rounding of the filtering states moves by ~1e-6 of
        # itself, and the sample takes its square root. The witness reads
        # how far two sound inversions of the same dynamics move the sample.
        r_cpu = {key: rel_max(got[key].cpu(), want[key]) for key in want}
        rec["f64_20k_rel_vs_cpu"] = r_cpu
        rec["posterior_sample_witness_rel"] = rel_max(witness, want["posterior_sample"])
        tol = {"grad": 1e-8, "posterior_sample": 1e-8, "posterior_sample_seed2": 1e-8}
        smoke.check(all(r <= tol.get(key, 1e-10) for key, r in r_cpu.items()),
                    f"float64 N={N_SMALL} card vs the CPU port (tol 1e-10, gradient and "
                    f"posterior samples 1e-8): {json.dumps(r_cpu)}; the sequential engine's "
                    f"posterior sample on the CPU against the block engine's: "
                    f"{rec['posterior_sample_witness_rel']!r}")

        # The Product and sum-c2 with its mean function at N_MAIN: routes,
        # float32 against float64; the D = 5 sum at N_D5 on the matrix path.
        other = {}
        for kind, cname, expect in (
                ("product", "logpdf", COMPOSITE_LAUNCHES["logpdf"]),
                ("product", "prior_rand", COMPOSITE_LAUNCHES["prior_rand"]),
                ("custom_mean", "logpdf", COMPOSITE_LAUNCHES["logpdf"]),
                ("custom_mean", "posterior_marginals", COMPOSITE_LAUNCHES["posterior_marginals"]),
                ("d5", "logpdf", {})):
            N = N_D5 if kind == "d5" else N_MAIN
            for name, dtype in dtypes.items():
                fx = make_other(kind, dtype, N, DEVICE)
                y = y_dev[name][:N]
                call = {"logpdf": lambda: logpdf(fx, y),
                        "prior_rand": lambda: rand(gen.manual_seed(SEED), fx),
                        "posterior_marginals": lambda: posterior_marginals(fx, y)}[cname]
                kernels.reset_launch_counts()
                out = call()
                torch.cuda.synchronize()
                counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
                out = out if isinstance(out, tuple) else (out,)
                other.setdefault(f"{kind}_{cname}", {})[name] = [t.double() for t in out]
                smoke.check(counts == expect and all(finite(t) for t in out),
                            f"{kind} {cname} {name} N={N}: finite, launches {counts} "
                            f"(want {expect})")
                with torch.no_grad():
                    ms = events_ms(call, reps=1 if kind == "d5" else 5, batches=3)
                rec.setdefault("ms", {}).setdefault(name, {})[f"{kind}_{cname}"] = ms[0]
                print(f"  {name} {kind}_{cname}: {ms[0]!r} ms (range {ms[1]!r}..{ms[2]!r})",
                      flush=True)
        # (The rand draws of the two dtypes come from different normals.)
        r_other = {key: max(rel_max(a, b) for a, b in zip(v["float32"], v["float64"]))
                   for key, v in other.items() if not key.endswith("rand")}
        rec["other_f32_vs_f64_rel"] = r_other
        smoke.check(all(r_other[f"{kind}_logpdf"] <= 1e-3
                        for kind in ("product", "custom_mean", "d5")),
                    f"Product, mean function and D = 5 float32 vs float64 lml (tol 1e-3); all, "
                    f"relative to the largest entry: {json.dumps(r_other)}")

        # Times (CUDA events, median of 5 batches; the new times 3) and
        # where the time goes.
        for name, dtype in dtypes.items():
            calls, fx, fxp_tr = composite_calls(dtype, N_MAIN, DEVICE, y_dev[name], gen)
            for cname, call in calls.items():
                batches, reps = ((3, 1) if cname == "posterior_logpdf_new_times"
                                 else (5, 1) if cname.startswith("posterior") else (5, 10))
                with torch.no_grad():
                    ms = events_ms(call, reps=reps, batches=batches)
                rec.setdefault("ms", {}).setdefault(name, {})[cname] = ms[0]
                print(f"  {name} sum-c2 {cname}: {ms[0]!r} ms (range {ms[1]!r}..{ms[2]!r}, "
                      f"{batches} batches of {reps})", flush=True)
            # The profiler names a kernel's streamed form as the kernel (K1's,
            # K7's and K3's kernels on another transition policy).
            streamed = ("phase1_aggregate", "phase2_starts", "phase3_states", "phase3_lml")
            for cname, shorts in (("logpdf", VALUE_KERNELS),
                                  ("value_and_grad", JVP_KERNELS),
                                  ("posterior_marginals", POSTERIOR_KERNELS),
                                  ("prior_rand", STATE_KERNELS[1:]),
                                  ("posterior_rand", streamed[:3] + STATE_KERNELS[1:]),
                                  ("posterior_logpdf", streamed),
                                  ("posterior_logpdf_new_times", streamed)):
                summary = call_profile(calls[cname], shorts,
                                       calls=3 if cname.startswith("posterior_") else 10)
                rec.setdefault("profile", {}).setdefault(name, {})[cname] = summary
                print(f"  {name} sum-c2 {cname} profile: {json.dumps(summary)}", flush=True)
                smoke.check(summary["device_busy_us"] > 0
                            and all(us > 0 for us in summary["kernel_us"].values()),
                            f"{name} sum-c2 {cname}: the profiler saw its kernels")

    # ---- 16. the Fisher gradient: this slice's main path -----------------
    def fisher_model(name, model_fn=None, p=None):
        """(model, y) as value_and_grad_fisher hands them to the block engine:
        c2's model_fn(p0) (or the given one's), the missing observation
        filled."""
        model = (model_fn or make_model_fn(dtypes[name], N_MAIN, DEVICE))(p0 if p is None else p)
        model_f, y_f, _ = transform_model_and_obs(model, y_dev[name])
        return model_f, y_f

    def compare_fisher_kernels(name):
        """Every kernel the Fisher call launches against its plain version at
        the inputs the call hands it (the shapes of phases 3 and 9; c2's
        model_fn(p0), whose noise is exp(log 0.1)): K1-K3 as phase 3 holds
        them on the forward's streams; K7 on the same streams; K8-K10 on the
        affine rows of the exact (jitter-free) posterior that the backward
        takes."""
        rows = lambda t: t.reshape(D + D * D, -1)
        model_f, y_f = fisher_model(name)
        A, a, Q, H, h, s, y, m0, P0 = block._fused_leaves(model_f, y_f)
        B = block._pallas_blocks(N_MAIN)
        y_main, s_main, _ = block._blocked_streams(y, s, B)
        packed = kernels.pack_params(A, a, Q, H, h, dtypes[name])
        P0 = symmetrize(P0)
        compare_values(name, y_main, s_main, packed, m0, P0, shape="fisher")
        starts = kernels.phase2_starts_plain(
            kernels.phase1_aggregate_plain(y_main, s_main, packed, D,
                                           chunks=kernels.PHASE1_AGGREGATE_CHUNKS)[0], m0, P0, D)
        p7 = kernels.phase3_states_plain(y_main, s_main, packed, starts, D,
                                         chunks=kernels.PHASE3_STATES_CHUNKS)
        k7 = kernels.phase3_states(y_main, s_main, packed, starts, D)
        torch.cuda.synchronize()
        record_comparison("phase3_states", name, k7, p7, rows(k7), rows(p7), "states",
                          shape="fisher")
        post = exact_posterior(model_f, y_f)
        compare_affine(name, block._affine_comps_iteration(post, B), post.trans.x0.mean,
                       symmetrize(post.trans.x0.cov), shape="fisher")

    def exact_posterior(model_f, y_f):
        """The backward's exact (jitter-free) posterior: the dynamics inverted
        against the block filter's predictions."""
        from temporalgps_torch.ops import fisher

        return fisher._exact_posterior(model_f, tlgssm.filter_(model_f, y_f, engine="block"))[0]

    def grad_excess(g, want, rtol, floor_rel):
        """Largest |g - want| - (rtol |want| + floor_rel max |want|), and
        the per-component relative errors."""
        floor = floor_rel * want.abs().max().item()
        err = (g.double() - want).abs()
        return (err - (rtol * want.abs() + floor)).max().item(), (err / want.abs()).tolist()

    def phase_fisher():
        from temporalgps_torch.learning import value_and_grad_fisher
        from temporalgps_torch.ops import fisher

        rec = smoke.record["fisher"] = {}
        out = {}
        for name, dtype in dtypes.items():
            compare_fisher_kernels(name)
            for label, fn_of, p in (("c2", make_model_fn, p0), ("sum-c2", make_sum_fn, p0_sum)):
                model_fn = fn_of(dtype, N_MAIN, DEVICE)
                for engine in ("block", "parallel") if label == "c2" else ("block",):
                    vg = value_and_grad_fisher(model_fn, y_dev[name], engine=engine)
                    kernels.reset_launch_counts()
                    v, g = vg(p)
                    torch.cuda.synchronize()
                    counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
                    want = FISHER_LAUNCHES if engine == "block" else FISHER_PARALLEL_LAUNCHES
                    rec.setdefault("launches", {})[f"{name}_{label}_{engine}"] = counts
                    smoke.check(counts == want and finite(v, g) and g.shape == p.shape,
                                f"{label} {name} value_and_grad_fisher engine={engine}: finite, "
                                f"launches {counts} (want {want})")
                    if (name, label, engine) == ("float32", "c2", "block"):
                        # This slice's main path: the kernels line adds its launches.
                        total = smoke.record.setdefault("launches", {})
                        for kn, n in counts.items():
                            total[kn] = total.get(kn, 0) + n
                    out[(name, label, engine)] = (v, g)
                v_f, g_f = value_and_grad_fwd_lgssm(model_fn, y_dev[name])(p)
                out[(name, label, "forward")] = (v_f, g_f)
                lml = logpdf_with_missings(model_fn(p), y_dev[name]).item()
                r_v = rel(out[(name, label, "block")][0].item(), lml)
                rec.setdefault("value_rel_vs_logpdf", {})[f"{name}_{label}"] = r_v
                smoke.check(r_v <= 1e-12, f"{label} {name} Fisher value {out[(name, label, 'block')][0].item()!r} "
                            f"vs logpdf {lml!r} rel={r_v:.3e} (tol 1e-12: the same K1-K3 call)")
        # The gradients against the forward mode's (K4-K6): float64 within
        # 1e-6 of each component plus 1e-8 of the largest, float32 within
        # 1e-3 plus 1e-6 of the largest (phase 6's gate) of the float64 one.
        for (name, label, engine), (v, g) in out.items():
            if engine == "forward":
                continue
            g64 = out[("float64", label, "forward")][1]
            rtol, floor = (1e-6, 1e-8) if name == "float64" else (1e-3, 1e-6)
            excess, r = grad_excess(g, g64, rtol, floor)
            rec.setdefault("grad_rel_vs_forward_f64", {})[f"{name}_{label}_{engine}"] = r
            smoke.check(excess <= 0.0,
                        f"{label} {name} Fisher gradient engine={engine} vs the float64 forward "
                        f"mode: per component {r} (tol {rtol:g} relative + {floor:g} of the "
                        f"largest, |g64|={g64.abs().tolist()})")
        rec["grads"] = {f"{n}_{l}_{e}": g.tolist() for (n, l, e), (_, g) in out.items()}

        # float64 at N_SMALL: the card against the CPU port (the kernels'
        # plain versions) and against the sequential engine's autograd.
        y_small = y_np[:N_SMALL]
        v_k, g_k = value_and_grad_fisher(make_model_fn(torch.float64, N_SMALL, DEVICE), y_small,
                                         engine="block")(p0)
        v_c, g_c = value_and_grad_fisher(make_model_fn(torch.float64, N_SMALL, "cpu"), y_small,
                                         engine="block")(p0.cpu())
        g_seq = autograd_grad("cpu", engine="sequential")
        r_cpu = max(rel(v_k.item(), v_c.item()), rel_max(g_k.cpu(), g_c))
        r_seq = rel_max(g_k.cpu(), g_seq)
        rec.update({"f64_20k_rel_vs_cpu": r_cpu, "f64_20k_grad_rel_vs_sequential": r_seq})
        smoke.check(r_cpu <= 1e-10 and r_seq <= 1e-6,
                    f"Fisher float64 N={N_SMALL}: card vs the CPU port rel={r_cpu:.3e} (tol "
                    f"1e-10); gradient vs the sequential engine's autograd rel={r_seq:.3e} "
                    f"(tol 1e-6)")

        # Times (CUDA events), where the time goes (torch.profiler and host
        # stages of the block engine's call).
        for name, dtype in dtypes.items():
            model_fn = make_model_fn(dtype, N_MAIN, DEVICE)
            vg = {engine: value_and_grad_fisher(model_fn, y_dev[name], engine=engine)
                  for engine in ("block", "parallel")}
            vg_sum = value_and_grad_fisher(make_sum_fn(dtype, N_MAIN, DEVICE), y_dev[name],
                                           engine="block")
            vg_fwd = value_and_grad_fwd_lgssm(model_fn, y_dev[name])
            calls = {"fisher_block": lambda: vg["block"](p0),
                     "fisher_parallel": lambda: vg["parallel"](p0),
                     "sum_c2_fisher_block": lambda: vg_sum(p0_sum),
                     "forward_mode": lambda: vg_fwd(p0)}
            for cname, call in calls.items():
                ms = events_ms(call, reps=1, batches=5)
                rec.setdefault("ms", {}).setdefault(name, {})[cname] = ms[0]
                print(f"  {name} {cname}: {ms[0]!r} ms (range {ms[1]!r}..{ms[2]!r}, 5 batches "
                      f"of 1)", flush=True)
            summary = call_profile(calls["fisher_block"], FISHER_KERNELS, calls=3)
            model_f, y_f = fisher_model(name)
            g1 = torch.ones((), dtype=dtype, device=DEVICE)
            stages = {
                "model_fn": lambda: model_fn(p0),
                "missing_data": lambda: transform_model_and_obs(model_fn(p0), y_dev[name]),
                "value_K1_K3": lambda: block.logpdf(model_f, y_f),
                "filter_K1_K2_K7": lambda: tlgssm.filter_(model_f, y_f, engine="block"),
                "filter_and_reversal": lambda: exact_posterior(model_f, y_f),
                "fisher_cotangents": lambda: fisher.fisher_cotangents(model_f, y_f, g1,
                                                                      engine="block"),
            }
            summary["host_stage_ms"] = {sname: stage_ms(fn, reps=5)[0]
                                        for sname, fn in stages.items()}
            post = exact_posterior(model_f, y_f)
            summary["host_stage_ms"]["latent_marginals_K8_K10"] = stage_ms(
                lambda: tlgssm.latent_marginals(post, engine="block"), reps=5)[0]
            rec.setdefault("profile", {})[name] = summary
            print(f"  {name} fisher_block profile: {json.dumps(summary)}", flush=True)
            smoke.check(summary["device_busy_us"] > 0
                        and all(us > 0 for us in summary["kernel_us"].values()),
                        f"{name} Fisher: the profiler saw K1-K3, K7 and K8-K10")

    # ---- 17. the alternative engines, the reverse block posterior, the
    # matrix path's inverse ----------------------------------------------
    def phase_engines():
        rec = smoke.record["engines"] = {}
        outs = {}
        for name, dtype in dtypes.items():
            fx = make_fx(dtype, N_MAIN, DEVICE)
            model_f, y_f, _ = transform_model_and_obs(build_lgssm(fx), y_dev[name])
            post = posterior_with_missings(build_lgssm(fx), y_dev[name])
            calls = {
                "block_logpdf": (lambda: tlgssm.logpdf(model_f, y_f, engine="block"),
                                 COMPOSITE_LAUNCHES["logpdf"]),
                "parallel_logpdf": (lambda: tlgssm.logpdf(model_f, y_f, engine="parallel"), {}),
                "sqrt_logpdf": (lambda: tlgssm.logpdf(model_f, y_f, engine="sqrt"), {}),
                # K1 and K3 around the square-root phase 2 (tensor ops, no K2).
                "block_sqrt_logpdf": (
                    lambda: tlgssm.logpdf(model_f, y_f, engine="block", phase2="sqrt"),
                    {"phase1_aggregate": 1, "phase3_lml": 1}),
                "block_posterior_marginals": (lambda: posterior_marginals(fx, y_dev[name], "block"),
                                              COMPOSITE_LAUNCHES["posterior_marginals"]),
                "parallel_posterior_marginals": (
                    lambda: posterior_marginals(fx, y_dev[name], "parallel"), {}),
                # c2's posterior (reverse-ordered) conditioned again: the
                # associative engine, no kernel.
                "reverse_block_posterior": (
                    lambda: tlgssm.posterior(post, y_f, engine="block"), {}),
            }
            for cname, (call, want) in calls.items():
                kernels.reset_launch_counts()
                got = call()
                torch.cuda.synchronize()
                counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
                if cname == "reverse_block_posterior":
                    smoke.check(got.trans.forward, "the reverse model's block posterior is "
                                "forward-ordered")
                    got = (got.trans.As, got.trans.offs, got.trans.Qs)
                got = got if isinstance(got, tuple) else (got,)
                outs[(name, cname)] = [t.double() for t in got]
                smoke.check(counts == want and all(finite(t) for t in got),
                            f"{name} {cname} N={N_MAIN}: finite, launches {counts} (want {want})")
                ms = events_ms(call, reps=1, batches=3)
                rec.setdefault("ms", {}).setdefault(name, {})[cname] = ms[0]
                print(f"  {name} {cname}: {ms[0]!r} ms (range {ms[1]!r}..{ms[2]!r}, 3 batches "
                      f"of 1)", flush=True)
        r = {}
        for kind in ("logpdf", "posterior_marginals"):
            for engine in ("parallel", "sqrt", "block_sqrt"):
                cname = f"{engine}_{kind}"
                if ("float64", cname) not in outs:
                    continue
                r[f"{cname}_f64_vs_block"] = max(rel_max(a, b) for a, b in zip(
                    outs[("float64", cname)], outs[("float64", f"block_{kind}")]))
                r[f"{cname}_f32_vs_f64"] = max(rel_max(a, b) for a, b in zip(
                    outs[("float32", cname)], outs[("float64", cname)]))
        rec["rel"] = r
        smoke.check(all(v <= (1e-9 if k.endswith("block") else 1e-3) for k, v in r.items()),
                    f"parallel, sqrt and phase2=sqrt at N={N_MAIN}: float64 vs the block "
                    f"engine (tol 1e-9), "
                    f"float32 vs float64 (tol 1e-3), relative to the largest entry: "
                    f"{json.dumps(r)}")

        # The reverse model's block posterior at N_SMALL, float64: the card
        # against the CPU's sequential engine (both conditionings).
        y_small = torch.as_tensor(y_np[:N_SMALL])
        leaves = {}
        for device, engine in ((DEVICE, None), ("cpu", "sequential")):
            model = build_lgssm(make_fx(torch.float64, N_SMALL, device))
            model_f, y_f, _ = transform_model_and_obs(model, y_small.to(device))
            first = tlgssm.posterior(model_f, y_f, engine=engine or "block")
            again = tlgssm.posterior(first, y_f, engine=engine or "block")
            t = again.trans
            leaves[device] = [t.As, t.offs, t.Qs, t.x0.mean, t.x0.cov]
        r_rev = max(rel_max(a.cpu(), b) for a, b in zip(leaves[DEVICE], leaves["cpu"]))
        rec["reverse_block_posterior_f64_20k_rel_vs_sequential"] = r_rev
        smoke.check(r_rev <= 1e-9, f"the reverse model's block posterior, float64 N={N_SMALL}, "
                    f"card vs the CPU's sequential engine rel={r_rev:.3e} (tol 1e-9)")

        # The matrix path's inverse (no jitter): the D = 5 sum at N_D5, the
        # float32 posterior means against float64 on the card; float64 at
        # N_D6_SMALL on the card against the CPU's sequential engine.
        means = {}
        for name, dtype in dtypes.items():
            fx5 = make_other("d5", dtype, N_D5, DEVICE)
            kernels.reset_launch_counts()
            means[name] = posterior_marginals(fx5, y_dev[name][:N_D5])[0].double()
            torch.cuda.synchronize()
            counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
            smoke.check(counts == {} and finite(means[name]),
                        f"D = 5 {name} N={N_D5} posterior means: the matrix path (no kernel "
                        f"launched), finite: {counts}")
            ms = events_ms(lambda: posterior_marginals(fx5, y_dev[name][:N_D5]), reps=1, batches=3)
            rec.setdefault("ms", {}).setdefault(name, {})["d5_posterior_marginals"] = ms[0]
            print(f"  {name} d5_posterior_marginals N={N_D5}: {ms[0]!r} ms", flush=True)
        r5 = rel_max(means["float32"], means["float64"])
        y5 = y_np[:N_D6_SMALL]
        m_k = posterior_marginals(make_other("d5", torch.float64, N_D6_SMALL, DEVICE), y5)[0]
        m_c = posterior_marginals(make_other("d5", torch.float64, N_D6_SMALL, "cpu"), y5,
                                  "sequential")[0]
        r5s = rel_max(m_k.cpu(), m_c)
        rec["d5"] = {"post_means_f32_vs_f64": r5, "f64_small_rel_vs_sequential": r5s}
        smoke.check(r5 <= 1e-3 and r5s <= 1e-10,
                    f"D = 5 matrix path: float32 posterior means vs float64 at N={N_D5} "
                    f"rel={r5:.3e} (tol 1e-3); float64 at N={N_D6_SMALL} vs the CPU's "
                    f"sequential engine rel={r5s:.3e} (tol 1e-10)")

    # ---- 18. exact space-time inference on the materialised grid (c4) ----
    # ---- space-time helpers (phases 18 and 19) ------------------------------
    def grid(dtype, ns, times, device=DEVICE):
        from temporalgps_torch.space_time import RectilinearGrid

        return RectilinearGrid(torch.linspace(-3, 3, ns, dtype=dtype, device=device), times)

    def make_c4(dtype, ns=C4_NS, hyper=C4_HYPER, nt=C4_NT, device=DEVICE):
        """c4's model on ns points x nt times; `hyper` (kernel variance,
        inverse lengthscales in space and time, noise) may be tensors, for a
        gradient."""
        from temporalgps_torch.gp import EQ
        from temporalgps_torch.space_time import Separable

        var, inv_s, inv_t, noise = hyper
        kern = var * Separable(EQ().stretch(inv_s), Matern52().stretch(inv_t))
        times = RegularSpacing(torch.tensor(0.0, dtype=dtype), torch.tensor(C4_DT, dtype=dtype),
                               nt)
        return to_sde(GP(kern), ArrayStorage(dtype), device=device)(
            grid(dtype, ns, times, device), noise)

    def new_grid(dtype):
        span = C4_DT * C4_NT
        return grid(dtype, C4_NS, RegularSpacing(0.0, span / C4_NT_NEW, C4_NT_NEW))

    def post_marginals(fx, y, engine, x_new=None):
        fp = gpost.posterior(fx, y)
        return gpost.marginals(fp(fx.x if x_new is None else x_new, NOISE), engine=engine)

    def timed(rec, key, call, batches=5):
        """The call's output; its median ms over `batches` batches of 1
        (CUDA events, the first the call that gives the output) recorded
        under key in rec, with that call's launches."""
        kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        end.synchronize()
        counts = {kn: n for kn, n in kernels.launch_counts().items() if n}
        times = [start.elapsed_time(end)]
        if batches > 1:
            times += [events_ms(call, reps=1, batches=1, warm_up=False)[0]
                      for _ in range(batches - 1)]
        ms = statistics.median(times)
        rec.setdefault("ms", {})[key] = ms
        rec.setdefault("launches", {})[key] = counts
        print(f"  {key}: {ms!r} ms (range {min(times)!r}..{max(times)!r}, {batches} batches "
              f"of 1), launches {counts}", flush=True)
        return out

    def batches_of(engine):
        # The sequential engine's calls take seconds: one batch, not 5
        # (3 batches spread 3-20% in earlier runs, against the 10-40x
        # between it and the batched engines).
        return 1 if engine == "sequential" else 5

    def phase_space_time():
        from temporalgps_torch.ops import assoc

        rec = smoke.record["c4"] = {}
        torch.cuda.reset_peak_memory_stats()
        y_np4 = np.random.default_rng(SEED).standard_normal(C4_NS * C4_NT)
        y_np4[C4_NAN_AT] = np.nan
        y4 = {name: torch.as_tensor(y_np4, dtype=dtype, device=DEVICE)
              for name, dtype in dtypes.items()}

        def post_means_in_f64(fx, y, x_new=None):
            """The posterior means of fx's float32 problem (its model and
            data as float32 stores them) solved in float64 on the parallel
            engine, at the training inputs or at x_new: gp.posterior's
            pipeline on the widened model."""
            fp = gpost.posterior(fx, y)
            fxp = fp(fx.x if x_new is None else x_new, NOISE)
            if x_new is None:
                x, noise, y_all, idx = fx.x, fx.noise, fp.y, None
                noise_pred = gpost._noise_array(fxp.noise, len(fx))
            else:
                x, noise, y_all, _, idx = gpost._build_inference_data(fp, x_new)
                noise_pred = gpost._pred_noise_full(idx, len(y_all), fxp.noise, y.dtype, DEVICE)
            model = build_lgssm(fx.f(x, noise))
            post = posterior_with_missings(widened(model), gpost._to_time_form(x, y_all).double(),
                                           engine="parallel")
            post = replace_observation_noise_cov(
                post, gpost._noise_leaf_like(model, x, noise_pred).double())
            m = tlgssm.marginals_diag(post, engine="parallel")[0].reshape(-1)
            return m if idx is None else m[torch.as_tensor(idx, device=DEVICE)]

        # logpdf and the posterior marginals (training inputs, the extended
        # horizon) on each engine and on engine=None, both dtypes.
        outs = {}
        for name, dtype in dtypes.items():
            fx = make_c4(dtype)
            for engine in C4_ENGINES + (None,):
                outs[(name, "logpdf", engine)] = timed(
                    rec, f"{name}_logpdf_{engine}", lambda: logpdf(fx, y4[name], engine=engine),
                    batches_of(engine))
            for engine in C4_ENGINES:
                outs[(name, "post", engine)] = timed(
                    rec, f"{name}_posterior_marginals_{engine}",
                    lambda: post_marginals(fx, y4[name], engine), batches_of(engine))
                outs[(name, "post_new", engine)] = timed(
                    rec, f"{name}_posterior_marginals_new_{engine}",
                    lambda: post_marginals(fx, y4[name], engine, new_grid(dtype)),
                    batches_of(engine))
        smoke.check(all(v == {} for v in rec["launches"].values()),
                    "c4 runs the matrix path: no kernel of K1-K10 launched")
        fx32 = make_c4(torch.float32)
        means_f32_problem = {"post": post_means_in_f64(fx32, y4["float32"]),
                             "post_new": post_means_in_f64(fx32, y4["float32"],
                                                           new_grid(torch.float32))}
        r, r_model = {}, {}
        for name in dtypes:
            for engine in C4_ENGINES + (None,):
                v = outs[(name, "logpdf", engine)].item()
                smoke.check(math.isfinite(v), f"c4 {name} logpdf engine={engine}: {v!r}")
                r[f"{name}_logpdf_{engine}"] = rel(v, outs[("float64", "logpdf", "sequential")]
                                                   .item())
            for kind in ("post", "post_new"):
                for engine in C4_ENGINES:
                    m, v = outs[(name, kind, engine)]
                    smoke.check(finite(m, v) and bool((v > 0).all())
                                and m.shape == (C4_NS * (C4_NT if kind == "post" else C4_NT_NEW),),
                                f"c4 {name} {kind} engine={engine}: finite, positive variances, "
                                f"shape {tuple(m.shape)}")
                    if name == "float64":
                        r[f"{name}_{kind}_means_{engine}"] = rel_max(
                            m, outs[("float64", kind, "sequential")][0])
                    else:
                        r[f"{name}_{kind}_means_{engine}"] = rel_max(
                            m.double(), means_f32_problem[kind])
                        r_model[f"{name}_{kind}_means_{engine}"] = rel_max(
                            m.double(), outs[("float64", kind, "sequential")][0])
        r_model["float32_problem_in_f64_post_means"] = rel_max(
            means_f32_problem["post"], outs[("float64", "post", "sequential")][0])
        rec["rel"] = r
        rec["float32_post_means_rel_vs_f64_model"] = r_model
        print(f"  distances: {json.dumps(r)}", flush=True)
        print(f"  float32 posterior means against the float64 model's (sequential): "
              f"{json.dumps(r_model)}", flush=True)
        # float32 posterior means: not gated against float64's (the float32
        # model's jitter puts every engine ~1.1e-2 away, printed above), but
        # against the float32 problem solved in float64, within 1e-3 or
        # F32_SPREAD times the float32 sequential engine's own distance
        # where that is larger (the rule phases 4, 9 and 13 apply to float32
        # kernels, the sequential engine as the plain version): 1e-3 alone
        # sits at float32's floor for this model.
        tol = {k: 1e-9 if k.startswith("float64") else
               max(1e-3, F32_SPREAD * r.get(re.sub(r"_[a-z]+$", "_sequential", k), 0.0))
               if "_means_" in k else 1e-3 for k in r}
        rec["tol"] = tol
        smoke.check(all(v <= tol[k] for k, v in r.items()),
                    "c4: float64 block and parallel within 1e-9 of float64 sequential (lml "
                    "relative, posterior means relative to the largest); float32 lml within "
                    "1e-3 of the float64 sequential lml; float32 posterior means within 1e-3 (or "
                    f"{F32_SPREAD} times the float32 sequential engine's distance) of the float32 "
                    "problem solved in float64, not of the float64 model's (missed by every "
                    f"engine, printed above): {json.dumps(tol)}")

        # Samples: the prior's rand; rand_with_eps on the card's engines
        # against its sequential engine on the same normals, float64.
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        ys = timed(rec, "float32_rand", lambda: rand(gen, make_c4(torch.float32)))
        smoke.check(finite(ys) and ys.shape == (C4_NS * C4_NT,),
                    f"c4 float32 prior rand: finite, shape {tuple(ys.shape)}")
        model64 = build_lgssm(make_c4(torch.float64))
        D4 = model64.latent_dim
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        eps = [torch.randn(shape, generator=g, dtype=torch.float64, device=DEVICE)
               for shape in ((C4_NT, D4), (C4_NT, C4_NS), (D4,))]
        samples = {engine: timed(rec, f"float64_rand_with_eps_{engine}",
                                 lambda: tlgssm.rand_with_eps(model64, *eps, engine=engine),
                                 batches_of(engine))
                   for engine in C4_ENGINES}
        r_s = {e: rel_max(samples[e], samples["sequential"]) for e in ("block", "parallel")}
        rec["rand_with_eps_f64_rel_vs_sequential"] = r_s
        smoke.check(all(v <= 1e-10 for v in r_s.values()),
                    f"c4 float64 rand_with_eps vs the sequential engine: {r_s} (tol 1e-10)")

        # The learning objective's autograd gradient (examples/
        # exact_space_time_learning.py), float64, block and parallel against
        # sequential.
        def objective(engine):
            def f(p):
                fx = make_c4(torch.float64, hyper=tuple(torch.exp(p)))
                return -logpdf(fx, y4["float64"], engine=engine) / (C4_NS * C4_NT)
            return f

        grads = {}
        for engine in C4_ENGINES:
            def value_and_grad(engine=engine):
                p = torch.log(torch.tensor(C4_HYPER, dtype=torch.float64, device=DEVICE))
                p.requires_grad_(True)
                v = objective(engine)(p)
                return v.detach(), torch.autograd.grad(v, p)[0]
            grads[engine] = timed(rec, f"float64_grad_{engine}", value_and_grad,
                                  batches_of(engine))
        r_g = {e: rel_max(grads[e][1], grads["sequential"][1]) for e in ("block", "parallel")}
        rec["grad"] = {e: g.tolist() for e, (_, g) in grads.items()}
        rec["grad_f64_rel_vs_sequential"] = r_g
        c4_parallel["outs"] = {(name, kind): outs[(name, short, "parallel")]
                               for name in dtypes for kind, short in (
                                   ("logpdf", "logpdf"), ("posterior_marginals", "post"),
                                   ("posterior_marginals_new", "post_new"))}
        c4_parallel["grad"] = grads["parallel"]
        smoke.check(all(finite(*grads[e]) and r <= 1e-8 for e, r in r_g.items()),
                    f"c4 float64 gradient vs the sequential engine's: {r_g} (tol 1e-8): "
                    f"{grads['block'][1].tolist()}")

        # The engine-choice table: logpdf and posterior marginals at D = 30
        # and D = 150 (the latter timed above).
        for name, dtype in dtypes.items():
            fx = make_c4(dtype, ns=C4_NS_SMALL)
            for engine in C4_ENGINES:
                timed(rec, f"{name}_ns{C4_NS_SMALL}_logpdf_{engine}",
                      lambda: logpdf(fx, y4[name][:C4_NS_SMALL * C4_NT], engine=engine),
                      batches_of(engine))
                timed(rec, f"{name}_ns{C4_NS_SMALL}_posterior_marginals_{engine}",
                      lambda: post_marginals(fx, y4[name][:C4_NS_SMALL * C4_NT], engine),
                      batches_of(engine))
        table = {f"{name} D={3 * ns}": {
            call: {engine: rec["ms"][f"{name}{'' if ns == C4_NS else f'_ns{ns}'}_{call}_{engine}"]
                   for engine in C4_ENGINES}
            for call in ("logpdf", "posterior_marginals")}
            for name in dtypes for ns in (C4_NS_SMALL, C4_NS)}
        rec["engine_table_ms"] = table
        print(f"  engine choice (ms): {json.dumps(table)}", flush=True)

        # The float32 inverse at D = 150: the program's (formed in float64,
        # assoc.MINV_WIDE_ABOVE_D), whose readings are gated above, beside
        # the LU inverse in float32 on the same calls. The LU readings are a
        # record, not a gate: the program does not run that inverse here
        # (probes/torch_c4_blocks.py times both at D = 3 to 150).
        def minv_lu(C, J):
            eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
            return torch.linalg.inv(eye + C @ J)

        lml64 = outs[("float64", "logpdf", "sequential")].item()
        variants = {"formed_in_float64": {
            f"{engine}_{key}": r[f"float32_{kind}_{engine}"]
            for engine in ("block", "parallel")
            for key, kind in (("logpdf_vs_f64", "logpdf"),
                              ("post_means_vs_f32_problem", "post_means"))}}
        v = variants["lu_float32"] = {}
        plain, assoc._minv = assoc._minv, minv_lu
        try:
            for engine in ("block", "parallel"):
                v[f"{engine}_logpdf_vs_f64"] = rel(
                    logpdf(fx32, y4["float32"], engine=engine).item(), lml64)
                v[f"{engine}_post_means_vs_f32_problem"] = rel_max(
                    post_marginals(fx32, y4["float32"], engine)[0].double(),
                    means_f32_problem["post"])
        finally:
            assoc._minv = plain
        rec["float32_inverse"] = variants
        print(f"  float32 inverse at D = {D4}: {json.dumps(variants)}", flush=True)

        # Where the time goes: torch.profiler over 2 calls of logpdf and of the
        # posterior marginals (engine=None), float32; the peak memory.
        fx = make_c4(torch.float32)
        for key, call in (("logpdf", lambda: logpdf(fx, y4["float32"])),
                          ("posterior_marginals", lambda: post_marginals(fx, y4["float32"], None))):
            ms = events_ms(call, reps=1, batches=3)[0]
            device_us, n_ops = device_profile(call, 2)
            busy = sum(device_us.values())
            top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
            summary = {"call_ms": ms, "device_busy_us": busy,
                       "idle_share": 1.0 - busy / (1e3 * ms), "device_ops_per_call": n_ops / 2,
                       "top_device_us": {k[:80]: v for k, v in top}}
            rec.setdefault("profile", {})[key] = summary
            print(f"  float32 {key} profile: {json.dumps(summary)}", flush=True)
            smoke.check(busy > 0, f"c4 {key}: the profiler saw device time")
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak memory {rec['peak_memory_bytes']} bytes", flush=True)

    # ---- 19. the Kronecker-factored engine -------------------------------
    def phase_kron():
        from temporalgps_torch.gp import lti_sde
        from temporalgps_torch.space_time import kron

        rec = smoke.record["kron"] = {}
        r, tol, none_takes, raised = {}, {}, {}, {}
        rec.update(rel=r, tol=tol, engine_none=none_takes, raises=raised)

        def wide(v):
            if isinstance(v, torch.Tensor):
                return v.double()
            if is_fill(v):
                return dataclasses.replace(v, value=v.value.double())
            if dataclasses.is_dataclass(v):  # the temporal prior, a Gaussian
                return dataclasses.replace(v, mean=v.mean.double(), cov=v.cov.double())
            return torch.float64  # the dtype field

        def kron_f32_problem(fx, y):
            """The posterior means of fx's float32 problem (its factors and
            data as float32 stores them) solved in float64 by the kron
            smoother."""
            fac = kron._factors(fx)
            fac = fac._replace(**{k: wide(v) for k, v in fac._asdict().items()})
            return kron._posterior_marginals(fac, fx.x, y.double(), None)[0].reshape(-1)

        def y_of(ns, nt, dtype):
            y = np.random.default_rng(SEED).standard_normal(ns * nt)
            y[C4_NAN_AT % (ns * nt)] = np.nan
            return torch.as_tensor(y, dtype=dtype, device=DEVICE)

        def choice(fx):
            """The engine that engine=None takes for each of fx's verbs on
            the card."""
            other = tlgssm._resolve_engine(None, build_lgssm(fx))
            return {verb: "kron" if lti_sde._route_kron(fx, None, verb) else other
                    for verb in ("logpdf", "marginals", "rand", "posterior")}

        def grad_call(engine, ns, nt, y):
            def call():
                p = torch.log(torch.tensor(C4_HYPER, dtype=torch.float64, device=DEVICE))
                p.requires_grad_(True)
                fx = make_c4(torch.float64, ns=ns, nt=nt, hyper=tuple(torch.exp(p)))
                v = -logpdf(fx, y, engine=engine) / (ns * nt)
                return v.detach(), torch.autograd.grad(v, p)[0]
            return call

        def profile(key, call):
            """torch.profiler over one call; the idle share against the
            call's median time above."""
            ms = rec["ms"][key]
            device_us, n_ops = device_profile(call, 1)
            busy = sum(device_us.values())
            top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
            summary = {"call_ms": ms, "device_busy_us": busy,
                       "idle_share": 1.0 - busy / (1e3 * ms), "device_ops_per_call": n_ops,
                       "top_device_us": {k[:80]: v for k, v in top}}
            rec.setdefault("profile", {})[key] = summary
            print(f"  {key} profile: {json.dumps(summary)}", flush=True)
            smoke.check(busy > 0, f"{key}: the profiler saw device time")

        def engine_none(key, fx, y, ns, nt):
            """engine=None's posterior marginals and rand on fx: they must run
            (a raise fails the phase) and be finite."""
            none_takes[key] = choice(fx)
            m, v = post_marginals(fx, y, None)
            draw = rand(torch.Generator(device=DEVICE).manual_seed(SEED), fx)
            smoke.check(m.shape == v.shape == draw.shape == (ns * nt,) and finite(m, v, draw)
                        and bool((v > 0).all()),
                        f"{key} engine=None ({none_takes[key]}): posterior marginals and rand "
                        "run, finite, positive variances")

        for shape, (ns, nt) in KRON_SHAPES.items():
            torch.cuda.reset_peak_memory_stats()
            c4 = shape == "c4"
            # At c4 only kron runs here: "parallel"'s outputs and times are
            # phase 18's, on the same model and data (its prior marginals
            # apart). c4's kron calls take 0.2-2.6 s: 3 batches there, one
            # for the new times and the gradient (the script's time limit).
            engines = ("kron",) if c4 else ("kron", "parallel", "block", "sequential")
            out = {}
            if c4:
                for (name, kind), o in c4_parallel["outs"].items():
                    out[name, kind, "parallel"] = o
                    rec.setdefault("ms", {})[f"c4_{name}_{kind}_parallel"] = \
                        smoke.record["c4"]["ms"][f"{name}_{kind}_parallel"]
            for name, dtype in dtypes.items():
                fx, y, key = make_c4(dtype, ns=ns, nt=nt), y_of(ns, nt, dtype), f"{shape}_{name}"

                def run(kind, engine, call, slow=False):
                    """timed() into out; a raise listed in KRON_EXPECTED_RAISES
                    is recorded, any other fails the phase."""
                    k = f"{key}_{kind}_{engine}"
                    try:
                        out[name, kind, engine] = timed(
                            rec, k, call, (1 if slow else 3) if c4 else batches_of(engine))
                    except torch.linalg.LinAlgError as err:
                        if k not in KRON_EXPECTED_RAISES:
                            raise
                        raised[k] = f"{type(err).__name__}: {str(err)[:160]}"
                        print(f"  {k} raises, as expected: {raised[k]}", flush=True)

                for engine in engines:
                    run("logpdf", engine, lambda: logpdf(fx, y, engine=engine))
                    run("posterior_marginals", engine, lambda: post_marginals(fx, y, engine))
                for engine in ("kron", "parallel"):
                    run("marginals", engine, lambda: marginals(fx, engine=engine))
                if c4:
                    run("posterior_marginals_new", "kron",
                        lambda: post_marginals(fx, y, "kron", new_grid(dtype)), slow=True)
                else:
                    run("rand", "parallel", lambda: rand(
                        torch.Generator(device=DEVICE).manual_seed(SEED), fx, engine="parallel"))
                for n in (None, 3):
                    def draw():
                        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
                        return rand(gen, fx, n, engine="kron")
                    ys = timed(rec, f"{key}_rand_n{n}_kron", draw, 3 if c4 else 5)
                    want = (ns * nt,) if n is None else (n, ns * nt)
                    smoke.check(ys.shape == want and finite(ys) and torch.equal(ys, draw()),
                                f"{key} kron rand n={n}: shape {tuple(ys.shape)}, finite, "
                                "the same draw from the same seed")
                engine_none(key, fx, y, ns, nt)
                if name == "float32":
                    # float32 posterior means against the float32 problem (the
                    # factors as float32 stores them) solved in float64 by
                    # the same smoother; within 1e-3 or F32_SPREAD times the
                    # float32 sequential engine's distance (phase 18's rule)
                    # where that engine's posterior exists (at c4 phase 18's
                    # reading of it, against the materialised float32 problem).
                    f32_problem = kron_f32_problem(fx, y)
                    d_seq = smoke.record["c4"]["rel"]["float32_post_means_sequential"] if c4 \
                        else None
                    for engine in engines:
                        if (name, "posterior_marginals", engine) in out:
                            d = rel_max(out[name, "posterior_marginals", engine][0].double(),
                                        f32_problem)
                            r_key = f"{shape}_float32_post_means_{engine}_vs_f32_problem"
                            (r if engine == "kron" else rec)[r_key] = d
                            d_seq = d if engine == "sequential" else d_seq
                    tol[f"{shape}_float32_post_means_kron_vs_f32_problem"] = max(
                        1e-3, F32_SPREAD * (d_seq or 0.0))
            # Gates: float64 kron against float64 parallel; float32 lml
            # against float64's; the other engines' distances printed.
            ref = lambda kind: out["float64", kind, "parallel"]
            kron64 = lambda kind: out["float64", kind, "kron"]
            r[f"{shape}_float64_logpdf"] = rel(kron64("logpdf").item(), ref("logpdf").item())
            posterior_kinds = ("posterior_marginals",) + ("posterior_marginals_new",) * c4
            for kind in ("marginals",) + posterior_kinds:
                r[f"{shape}_float64_{kind}_means"] = rel_max(kron64(kind)[0], ref(kind)[0])
            r[f"{shape}_float64_marginals_vars"] = rel_max(kron64("marginals")[1],
                                                           ref("marginals")[1])
            r[f"{shape}_float32_logpdf_vs_f64"] = rel(out["float32", "logpdf", "kron"].item(),
                                                      kron64("logpdf").item())
            # The posterior variances by the reference's own test of its kron
            # smoother against its sequential one (tests/test_space_time.py:
            # |a - b| <= 1e-8 + 1e-7 |b| elementwise; recorded as the largest
            # ratio of the two sides, gated at 1): both smoothers carry
            # POSTERIOR_JITTER in their gains, the kron one (the reference's
            # formula) not in its backward recursion, which moves the
            # variances by ~1e-10 J J^T (CPU, float64, c4: 5.7e-8 of the
            # largest at the training inputs, 1.24e-7 at the new times; the
            # means 1e-12).
            for kind in posterior_kinds:
                a, b = kron64(kind)[1], ref(kind)[1]
                r[f"{shape}_float64_{kind}_vars"] = (
                    (a - b).abs() / (1e-8 + 1e-7 * b.abs())).max().item()
                tol[f"{shape}_float64_{kind}_vars"] = 1.0
            for k in r:
                if k.startswith(shape):
                    tol.setdefault(k, 1e-9 if "float64" in k else 1e-3)
            for engine in engines[2:]:
                rec[f"{shape}_float64_logpdf_{engine}_vs_parallel"] = rel(
                    out["float64", "logpdf", engine].item(), ref("logpdf").item())
            for (name, kind, engine), o in out.items():
                if kind.startswith("posterior"):
                    smoke.check(finite(*o) and bool((o[1] > 0).all()),
                                f"{shape} {name} {kind} {engine}: finite, positive variances")

            # The float64 objective's autograd gradient, kron against parallel
            # (at c4 phase 18's).
            y64 = y_of(ns, nt, torch.float64)
            grads = {"kron": timed(rec, f"{shape}_float64_grad_kron",
                                   grad_call("kron", ns, nt, y64), 1 if c4 else 5)}
            if c4:
                grads["parallel"] = c4_parallel["grad"]
                rec["ms"]["c4_float64_grad_parallel"] = smoke.record["c4"]["ms"][
                    "float64_grad_parallel"]
            else:
                grads["parallel"] = timed(rec, f"{shape}_float64_grad_parallel",
                                          grad_call("parallel", ns, nt, y64), 5)
            r[f"{shape}_float64_grad"] = rel_max(grads["kron"][1], grads["parallel"][1])
            tol[f"{shape}_float64_grad"] = 1e-8
            rec[f"{shape}_grad"] = {e: g[1].tolist() for e, g in grads.items()}
            smoke.check(finite(*grads["kron"]), f"{shape} kron gradient finite")

            fx32, y32 = make_c4(torch.float32, ns=ns, nt=nt), y_of(ns, nt, torch.float32)
            for kind, call in (("logpdf", lambda: logpdf(fx32, y32, engine="kron")),
                               ("posterior_marginals", lambda: post_marginals(fx32, y32, "kron"))):
                profile(f"{shape}_float32_{kind}_kron", call)
            rec[f"{shape}_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            print(f"  {shape} peak memory {rec[f'{shape}_peak_memory_bytes']} bytes", flush=True)

        # engine=None where only the float32 rule takes kron.
        ns, nt = KRON_GAP
        engine_none(f"{ns}x{nt}_float32", make_c4(torch.float32, ns=ns, nt=nt),
                    y_of(ns, nt, torch.float32), ns, nt)
        table = {}
        for key, ms in rec["ms"].items():
            m = re.fullmatch(r"(.+)_(logpdf|posterior_marginals)_(kron|parallel)", key)
            if m:
                table.setdefault(m[1], {}).setdefault(m[2], {})[m[3]] = ms
        rec["engine_table_ms"] = table
        print(f"  engine choice (ms): {json.dumps(table)}", flush=True)
        print(f"  engine=None takes: {json.dumps(none_takes)}", flush=True)

        # The card against the CPU port at a small grid, float64.
        ns, nt = KRON_SMALL
        rng = np.random.default_rng(SEED + 19)
        y_s = rng.standard_normal(ns * nt)
        y_s[17] = np.nan
        t_new = np.sort(rng.uniform(0.0, 0.3, 9))
        eps = [rng.standard_normal(shp) for shp in ((3, ns), (nt, 3, ns), (nt, ns))]

        def small(device):
            fx = make_c4(torch.float64, ns=ns, nt=nt, device=device)
            fp = gpost.posterior(fx, y_s)
            x_new = grid(torch.float64, ns, torch.as_tensor(t_new, device=device), device)
            got = [logpdf(fx, y_s, engine="kron").reshape(1), *marginals(fx, engine="kron"),
                   *gpost.marginals(fp(fx.x, NOISE), engine="kron"),
                   *gpost.marginals(fp(x_new, NOISE), engine="kron"),
                   kron.rand_with_eps(fx, *(torch.as_tensor(e, device=device) for e in eps))]
            return [t.cpu() for t in got]

        kernels.reset_launch_counts()
        on_card = small(DEVICE)
        smoke.check(sum(kernels.launch_counts().values()) == 0, "kron launches no kernel")
        r_small = max(rel_max(a, b) for a, b in zip(on_card, small("cpu")))
        r["small_float64_card_vs_cpu"], tol["small_float64_card_vs_cpu"] = r_small, 1e-9

        smoke.check(all(v == {} for v in rec["launches"].values()),
                    "kron and the materialised engines launch no kernel of K1-K10")
        print(f"  distances: {json.dumps(r)}", flush=True)
        smoke.check(all(v <= tol[k] for k, v in r.items()),
                    "kron: float64 within 1e-9 of float64 parallel (lml, prior marginals, "
                    "posterior means; posterior variances within 1e-8 + 1e-7 |v|; the gradient "
                    "1e-8) and of the CPU port; float32 lml within 1e-3 "
                    "of float64; float32 posterior means within 1e-3 (or "
                    f"{F32_SPREAD} times the float32 sequential engine's distance) of the "
                    f"float32 problem solved in float64: {json.dumps(tol)}")

    # ---- 20. c5: the pseudo-point models --------------------------------
    def phase_c5():
        from temporalgps_torch.gp import EQ
        from temporalgps_torch.space_time import (RectilinearGrid, Separable,
                                                  approx_posterior_marginals, dtc, elbo,
                                                  regular_in_time)

        rec = smoke.record["c5"] = {}
        r, tol = {}, {}
        rec.update(rel=r, tol=tol)

        def make_c5(dtype, nt, p, ns=C5_NS, device=DEVICE):
            s2, sc, noise = torch.exp(p)
            kern = s2 * Separable(EQ().stretch(sc), Matern52())
            times = RegularSpacing(torch.tensor(0.0, dtype=dtype, device=device),
                                   torch.tensor(0.01, dtype=dtype, device=device), nt)
            x = RectilinearGrid(torch.linspace(-3, 3, ns, dtype=dtype, device=device), times)
            return to_sde(GP(kern), ArrayStorage(dtype), device=device)(x, noise)

        def inducing(dtype, m=C5_M, device=DEVICE):
            return torch.linspace(-3, 3, m, dtype=dtype, device=device)

        def p_at(dtype, device=DEVICE, grad=False):
            return torch.tensor(C5_P0, dtype=dtype, device=device, requires_grad=grad)

        def vg(fx_of, y, z, engine, device=DEVICE, dtype=torch.float32):
            """elbo and its autograd gradient in log (s2, sc, noise)."""
            def call():
                p = p_at(dtype, device, grad=True)
                v = elbo(fx_of(p), y, z, engine=engine, nan_fallback=False)
                return v.detach(), torch.autograd.grad(v, p)[0]
            return call

        def grad_excess(g32, g64):
            """phase 6's rule: 1e-3 of each component, a floor of 1e-6 of the
            largest; <= 0 passes."""
            floor = 1e-6 * g64.abs().max().item()
            return ((g32.double() - g64).abs() - (1e-3 * g64.abs() + floor)).max().item()

        rng0 = np.random.default_rng(SEED)
        y_np = {"block": rng0.standard_normal(C5_NT_BLOCK * C5_NS),
                "steady": rng0.standard_normal(C5_NT_STEADY * C5_NS)}
        nts = {"block": C5_NT_BLOCK, "steady": C5_NT_STEADY}
        x_new = {name: torch.linspace(-3.5, 3.5, C5_NEW, dtype=dtype, device=DEVICE)
                 for name, dtype in dtypes.items()}
        out = {}
        for name, dtype in dtypes.items():
            z = inducing(dtype)
            for engine in ("steady", "block"):
                y = torch.as_tensor(y_np[engine], dtype=dtype, device=DEVICE)
                fx_of = functools.partial(make_c5, dtype, nts[engine])
                if engine == "steady":
                    torch.cuda.reset_peak_memory_stats()
                    out[name, "elbo", engine] = timed(rec, f"{name}_elbo_{engine}", lambda: elbo(
                        fx_of(p_at(dtype)), y, z, engine=engine, nan_fallback=False), 3)
                    rec[f"{name}_elbo_steady_peak_bytes"] = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                out[name, "vg", engine] = timed(rec, f"{name}_elbo_grad_{engine}",
                                                vg(fx_of, y, z, engine, dtype=dtype), 3)
                if engine == "steady":
                    rec[f"{name}_elbo_grad_steady_peak_bytes"] = torch.cuda.max_memory_allocated()
                    out[name, "dtc", engine] = timed(rec, f"{name}_dtc_{engine}", lambda: dtc(
                        fx_of(p_at(dtype)), y, z, engine=engine), 3)
                    out[name, "apm", engine] = timed(
                        rec, f"{name}_approx_posterior_marginals_{engine}",
                        lambda: approx_posterior_marginals(fx_of(p_at(dtype)), y, z,
                                                           x_new[name], engine=engine), 3)
                del y
        for name in dtypes:
            for what in ("elbo", "elbo_grad"):
                key = f"{name}_{what}_steady_peak_bytes"
                print(f"  {key}: {rec[key]}", flush=True)
        for (name, kind, engine), o in out.items():
            vals = o if isinstance(o, tuple) else (o,)
            smoke.check(finite(*vals), f"c5 {name} {kind} {engine}: finite")
            if kind == "apm":
                smoke.check(o[0].shape == (C5_NEW * nts[engine],) and bool((o[1] > 0).all()),
                            f"c5 {name} approx posterior {engine}: shape, positive variances")
        for engine in ("steady", "block"):
            (v32, g32), (v64, g64) = out["float32", "vg", engine], out["float64", "vg", engine]
            r[f"float32_elbo_{engine}_vs_f64"] = rel(v32.item(), v64.item())
            rec[f"float32_grad_{engine}_excess_over_phase6_gate"] = grad_excess(g32, g64)
            smoke.check(grad_excess(g32, g64) <= 0, f"c5 float32 {engine} gradient within 1e-3 "
                        f"of float64's per component: {g32.tolist()} vs {g64.tolist()}")
        r["float32_dtc_steady_vs_f64"] = rel(out["float32", "dtc", "steady"].item(),
                                             out["float64", "dtc", "steady"].item())
        r["float32_apm_means_steady_vs_f64"] = rel_max(out["float32", "apm", "steady"][0].double(),
                                                       out["float64", "apm", "steady"][0])
        rec["values"] = {f"{n}_{k_}_{e}": (o[0].item() if k_ == "vg" else o.item())
                         for (n, k_, e), o in out.items() if k_ in ("vg", "elbo", "dtc")}
        rec["grads"] = {f"{n}_{e}": o[1].tolist() for (n, k_, e), o in out.items() if k_ == "vg"}
        del out

        # The bench's cross-check: steady against block at Nt = 100k, float64.
        y64 = torch.as_tensor(y_np["block"], dtype=torch.float64, device=DEVICE)
        fx_of = functools.partial(make_c5, torch.float64, C5_NT_BLOCK)
        z64 = inducing(torch.float64)
        v_st, g_st = timed(rec, "float64_elbo_grad_steady_nt100k",
                           vg(fx_of, y64, z64, "steady", dtype=torch.float64), 3)
        v_bl, g_bl = vg(fx_of, y64, z64, "block", dtype=torch.float64)()
        # The exact engines themselves part at ~1e-9 on this model in float64
        # (CPU, 50 x 3000: "parallel" 9.2e-10 and "lti" 8.6e-10 from "block",
        # steady 1.4e-9, 1.1e-9 with a 2048-step warmup): the value is gated
        # at 1e-9 or F32_SPREAD times "parallel"'s distance from "block".
        v_pa = timed(rec, "float64_elbo_parallel_nt100k", lambda: elbo(
            fx_of(p_at(torch.float64)), y64, z64, engine="parallel", nan_fallback=False), 1)
        r["float64_parallel_vs_block_nt100k_value"] = rel(v_pa.item(), v_bl.item())
        r["float64_steady_vs_block_nt100k_value"] = rel(v_st.item(), v_bl.item())
        tol["float64_steady_vs_block_nt100k_value"] = max(
            1e-9, F32_SPREAD * r["float64_parallel_vs_block_nt100k_value"])
        tol["float64_parallel_vs_block_nt100k_value"] = 1e-8
        excess = ((g_st - g_bl).abs() - (1e-6 * g_bl.abs() + 1e-8 * g_bl.abs().max())).max().item()
        rec["float64_steady_vs_block_nt100k_grad_excess"] = excess
        smoke.check(excess <= 0, f"c5 steady-vs-block gradient at Nt = 100k, float64: "
                    f"{g_st.tolist()} vs {g_bl.tolist()} (1e-6 of each + 1e-8 of the largest)")

        # The engine readings at Nt = 100k: the float32 elbo.
        y32 = torch.as_tensor(y_np["block"], dtype=torch.float32, device=DEVICE)
        del y_np
        fx_of = functools.partial(make_c5, torch.float32, C5_NT_BLOCK)
        readings = {}
        for engine in ("parallel", "block", "lti", "steady"):
            readings[engine] = timed(rec, f"float32_elbo_nt100k_{engine}", lambda: elbo(
                fx_of(p_at(torch.float32)), y32, inducing(torch.float32), engine=engine,
                nan_fallback=False), 3).item()
        rec["engine_readings_ms"] = {e: rec["ms"][f"float32_elbo_nt100k_{e}"] for e in readings}
        r["float32_elbo_nt100k_spread"] = max(rel(v, readings["block"])
                                              for v in readings.values())
        print(f"  engine readings at Nt = 100k (ms): {json.dumps(rec['engine_readings_ms'])}",
              flush=True)
        del y32, y64

        # The ragged case (examples/approx_space_time_learning.py), float64.
        for nt in C5_RAGGED_NT:
            rng = np.random.default_rng(SEED)
            ts = np.cumsum(0.01 + rng.random(nt) * 0.01)
            counts = rng.integers(25, 51, nt)
            splits = np.split(rng.uniform(-3, 3, counts.sum()), np.cumsum(counts)[:-1])
            x = regular_in_time(ts, [np.sort(v) for v in splits])
            y = torch.as_tensor(rng.standard_normal(len(x)), device=DEVICE)
            z = inducing(torch.float64)
            r_pr = torch.linspace(-3, 3, 25, dtype=torch.float64, device=DEVICE)

            def fx_of(p, x=x):
                s2, sc, noise = torch.exp(p)
                kern = s2 * Separable(EQ().stretch(sc), Matern52())
                return to_sde(GP(kern), device=DEVICE)(x, noise)

            got, batches = {}, 3 if nt <= 1000 else 1
            for engine in ("block", "parallel"):
                got[engine] = (
                    timed(rec, f"ragged{nt}_elbo_grad_{engine}",
                          vg(fx_of, y, z, engine, dtype=torch.float64), batches),
                    timed(rec, f"ragged{nt}_approx_posterior_marginals_{engine}",
                          lambda: approx_posterior_marginals(fx_of(p_at(torch.float64)), y, z,
                                                             r_pr, engine=engine), batches))
                (v, g), (m, var) = got[engine]
                smoke.check(finite(v, g, m, var) and bool((var > 0).all())
                            and m.shape == (25 * nt,),
                            f"c5 ragged Nt={nt} {engine}: finite, positive variances")
            (vb, gb), (mb, _) = got["block"]
            (vp, gp), (mp, _) = got["parallel"]
            for what, value, t in (("value", rel(vp.item(), vb.item()), 1e-9),
                                   ("grad", rel_max(gp, gb), 1e-7),
                                   ("means", rel_max(mp, mb), 1e-7)):
                r[f"ragged{nt}_{what}_parallel_vs_block"] = value
                tol[f"ragged{nt}_{what}_parallel_vs_block"] = t
            rec[f"ragged{nt}_observations"] = len(x)
            del got, y

        # The card against the CPU port at the bench's SMOKE sizes, float64;
        # the elbo below the exact lml.
        ns, nt, m = C5_SMOKE
        y_s = np.random.default_rng(SEED + 20).standard_normal(ns * nt)
        new_s = np.linspace(-3.5, 3.5, 4)

        def small(device):
            fx_of = lambda p: make_c5(torch.float64, nt, p, ns=ns, device=device)
            z = inducing(torch.float64, m, device)
            res = {}
            for engine in C5_ENGINES:
                v, g = vg(fx_of, y_s, z, engine, device, torch.float64)()
                res[engine] = [v.reshape(1), g]
                if engine in ("block", "parallel", "steady"):
                    res[engine] += list(approx_posterior_marginals(
                        fx_of(p_at(torch.float64, device)), y_s, z,
                        torch.as_tensor(new_s, device=device), engine=engine))
            exact = logpdf(fx_of(p_at(torch.float64, device)), y_s, engine="parallel").item()
            return {e: [t.detach().cpu() for t in ts] for e, ts in res.items()}, exact

        kernels.reset_launch_counts()
        on_card, exact = small(DEVICE)
        rec["launches"]["smoke_sizes"] = {kn: n for kn, n in kernels.launch_counts().items() if n}
        on_cpu, _ = small("cpu")
        for engine in C5_ENGINES:
            card, cpu = on_card[engine], on_cpu[engine]
            r[f"smoke_float64_{engine}_value_card_vs_cpu"] = rel(card[0].item(), cpu[0].item())
            r[f"smoke_float64_{engine}_grad_card_vs_cpu"] = rel_max(card[1], cpu[1])
            tol[f"smoke_float64_{engine}_value_card_vs_cpu"] = 1e-10
            tol[f"smoke_float64_{engine}_grad_card_vs_cpu"] = 1e-8
            for i, what in ((2, "means"), (3, "vars")):
                if len(card) > i:
                    r[f"smoke_float64_{engine}_apm_{what}_card_vs_cpu"] = rel_max(card[i], cpu[i])
                    tol[f"smoke_float64_{engine}_apm_{what}_card_vs_cpu"] = 1e-10
        rec["smoke_exact_lml"] = exact
        rec["smoke_elbo"] = {e: on_card[e][0].item() for e in C5_ENGINES}
        smoke.check(all(on_card[e][0].item() <= exact + 1e-8 for e in C5_ENGINES),
                    f"c5 at {ns} x {nt}: the elbo {json.dumps(rec['smoke_elbo'])} below the "
                    f"exact lml {exact!r} on every engine")

        # Where the time goes: one float32 steady elbo + gradient at 1M.
        y = torch.as_tensor(np.random.default_rng(SEED + 21).standard_normal(C5_NT_STEADY * C5_NS),
                            dtype=torch.float32, device=DEVICE)
        call = vg(functools.partial(make_c5, torch.float32, C5_NT_STEADY), y,
                  inducing(torch.float32), "steady")
        ms = events_ms(call, reps=1, batches=3)[0]
        device_us, n_ops = device_profile(call, 1)
        busy = sum(device_us.values())
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        rec["profile"] = {"call_ms": ms, "device_busy_us": busy,
                          "idle_share": 1.0 - busy / (1e3 * ms), "device_ops_per_call": n_ops,
                          "top_device_us": {k_[:80]: v for k_, v in top}}
        print(f"  float32 steady elbo + grad profile: {json.dumps(rec['profile'])}", flush=True)
        smoke.check(busy > 0, "c5: the profiler saw device time")

        for k_ in r:
            tol.setdefault(k_, 1e-3)
        print(f"  distances: {json.dumps(r)}", flush=True)
        smoke.check(all(v == {} for v in rec["launches"].values()),
                    "c5 launches no kernel of K1-K10")
        smoke.check(all(v <= tol[k_] for k_, v in r.items()),
                    "c5: float32 within 1e-3 of float64 (elbo, dtc, approximate posterior "
                    "means); the steady-block cross-check (value 1e-9, or F32_SPREAD times the "
                    "exact engines' own spread); the ragged block and "
                    "parallel within 1e-9 (value) and 1e-7 (gradient, means); the card within "
                    f"1e-10 of the CPU port at the SMOKE sizes (gradients 1e-8): {json.dumps(tol)}")

    smoke.phase("1. versions and card", phase_versions)
    smoke.phase("2. build", phase_build)
    smoke.phase("3. value kernels vs plain versions at N=1M", phase_compare)
    smoke.phase("4. forward-mode kernels vs plain versions at N=1M", phase_compare_jvp)
    smoke.phase("5. lml path", phase_main_path)
    smoke.phase("6. training path", phase_training)
    smoke.phase("7. timing at N=1M", phase_timing)
    smoke.phase("8. profile of value_and_grad at N=1M", phase_profile)
    smoke.phase("9. state-emitting kernels vs plain versions at N=1M", phase_compare_states)
    smoke.phase("10. posterior path", phase_posterior)
    smoke.phase("11. timing of the posterior path", phase_timing_states)
    smoke.phase("12. profile of posterior marginals at N=1M", phase_profile_posterior)
    smoke.phase("13. streamed kernels vs plain versions at N=1M", phase_compare_streamed)
    smoke.phase("14. irregular times and D = 6", phase_irregular)
    smoke.phase("15. sum-c2: composite models, sampling, the posterior's logpdf", phase_composite)
    smoke.phase("16. the Fisher gradient at N=1M", phase_fisher)
    smoke.phase("17. engines parallel and sqrt, the reverse block posterior, D = 5", phase_engines)
    smoke.phase("18. c4: exact space-time inference on the materialised grid", phase_space_time)
    smoke.phase("19. kron: the factored engine at c4 and 247 x 100", phase_kron)
    smoke.phase("20. c5: the pseudo-point models on steady, block and the ragged case",
                phase_c5)

    print("== detail", json.dumps(smoke.record, default=str))
    if smoke.failures:
        print("chip_smoke FAILED:", *smoke.failures, sep="\n  ", file=sys.stderr)
        return 1
    kernels_line = {"kernels": [
        {
            "name": kname,
            "route": "cuda",
            "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": smoke.record["launches"][kname],
            "max_abs_err": smoke.record[kname]["float32"]["max_abs_err"],
            "ms": smoke.record[kname]["float32"]["ms"],
            "plain_ms": smoke.record[kname]["float32"]["plain_ms"],
            "bound_ms": smoke.record[kname]["float32"]["bound_ms"],
            "bound_by": smoke.record[kname]["float32"]["bound_by"],
            # No single PyTorch operator folds Kalman filtering elements or
            # runs the recursion, so there is no library call to time.
            "library_ms": None,
        }
        for kname in REPLACES
    ]}
    print(smoke.record["card"])
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
