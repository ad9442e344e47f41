#!/usr/bin/env python3
"""Smoke run of mdx_torch's fused QA pass, tuning sweep, raw ingest, sharded
paths, capability probe, CLI, spatial runner, data axis, JPEG codecs
(lossless JPEG, JPEG-LS, DCT JPEG, JPEG 2000), transcoder, JSON API,
GenAI mode and deploy-time priming on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  Phases, each reported on its own lines:

1. device  — the card's name and power limit, its uncorrected ECC errors,
   row remappings and temperature (again on stderr after a failure);
   TF32 off.
2. build   — nvcc builds the kernels from ``mdx_torch/csrc``.
3. kernels — each CUDA kernel (box stats, unsharp, CLAHE, TV, bilateral,
   wavelet denoise, the select kernel of the metric percentiles) against
   its plain PyTorch version on the card at
   [4,512,512], held to ``mdx_torch.parity.KERNEL_TOL``; TV's per-image
   iteration counts must be equal; the wavelet denoise soft, hard, with a
   mixed soft mask and with ``sigma=None`` through ``denoise_wavelet``;
   its coarse stages at 512^2 and 2048^2, a non-square shape, one- and
   three-level stages, zero sigma and a flat image, the transform pair
   bit-equal to the plain version's with sigma 0, two runs bit-equal.
   CLAHE at tile sizes 8, 12, 16 and 32, extents that are not multiples of
   the tile, single-tile images and adversarial histograms, its LUT stage
   too, two runs bit-equal.
   TV's blocked schedule (s iterations a launch): caps 1 .. 2s + 1 with
   eps = 0 (a stop at every offset of a launch, short last launches), a
   batch whose images stop in three different launches, and the shapes
   [2,5,7], [3,33,129] and [2,1024,1100], each with its schedule
   (iterations a launch, launches, host flag reads).
   Unsharp at every support r_eff 0 .. 12 (and above), 1x1, 1xW, Hx1,
   sub-tile and non-square images, NaN and +inf pixels beyond a tile edge
   and NaN taps; bilateral at d = 1 .. 9 on heights and widths of 1 and 2,
   per-image sigmas, sigma 0 and NaN pixels: both bit-equal to their plain
   versions (NaN in the same places) and on two runs.
4. slice   — ``qa_plan`` with the bench plan and ``qa_deterministic`` on
   [2,512,512], on the card (kernels) against the CPU (plain versions),
   within the tolerances of ``mdx_torch.parity``.
5. 512^2   — ``qa_plan`` and ``qa_deterministic`` on the bench's 32x512^2
   batch with every launch counter reset first; every kernel must have
   launched and every output must be finite.  Every kernel call of that run
   is recorded and replayed against the plain version on the same inputs
   (TV on the chain's intermediate, as the main path gives it).  Then
   times: img/s (median of synchronised reps), the pass's rows ``qa_plan
   total``, ``image_stats`` and ``op tv_denoise``
   (``mdx_torch.tools.profile_pass``) and the traced idle share of one
   ``qa_plan``, and each kernel against its plain version at 32x512^2,
   whose outputs are compared too (TV: iterations a launch, ms per
   iteration, host flag reads per solve), and the select kernel at a CT
   chunk's rows, [64, 512^2].
6. 2048^2  — BASELINE config 2 and the large-slice path:
   1. each kernel against its plain version at [1,2048,2048] (the wavelet
      cases of phase 3 at [2,2048,2048]);
   2. config 2 (``mdx_torch.tools.bench_config2``: denoise, CLAHE, unsharp
      and the guards, in groups of ``group_limit``) on 64x2048^2, counters
      reset first: box stats, CLAHE, unsharp and the wavelet denoise must
      launch, the output
      must be finite; the kernel calls of the first group are recorded and
      replayed against the plain versions;
   3. ``qa_plan`` with the bench plan at 16x2048^2 (one group; the batch
      cut from 64 so that TV and bilateral run at 2048^2): every kernel
      must launch, outputs finite, every kernel call replayed;
   4. config 2's ``apply_plan`` at [1,2048,2048] on the card against the
      CPU, within ``parity.breaches``;
   5. times: config 2 at 64x2048^2 (ms per batch, img/s, peak memory),
      the pass's rows at 16x2048^2 as in phase 5, and each kernel against
      its plain version at 16x2048^2, the group the 2048^2 path hands
      each kernel (the select kernel also on the group's finest db2 HH
      band, whose median is the MAD sigma).
7. tuning  — ``mdx_torch.core.tuning`` at full size:
   1. ``autotune`` on one 512^2 frame with issues noise and blur (27
      lanes), on one 2048^2 frame (27 lanes in 3 groups of 9) and
      ``autotune_batch`` on 4x512^2 frames (108 lanes), counters reset
      before each: box stats, CLAHE, unsharp and the wavelet denoise must
      launch, outputs finite, one chosen record per sweep; the 512^2
      sweep's kernel calls replayed against the plain versions;
   2. the 512^2 sweep on the card against the CPU: scores within
      ``TUNE_SCORE_ATOL``, the same best candidate (or, where a last-ulp
      tie picks another, the two candidates' scores within it on both
      sides), the picked image within ``parity.breaches``;
   3. ms per sweep of each of the three (median of synchronised reps).
8. ingest  — 64 frames of 512^2 stored as 12-bit uint16 with a CT-like
   rescale (slope 1, intercept -1024): upload, ``normalize_ingest`` and
   ``qa_deterministic``, per-frame min-max and stack-global bounds; finite
   on 64 frames, the card against the CPU on 2 within ``parity.breaches``,
   img/s timed with the upload.
9. spatial — the row-sharded path (``mdx_torch.parallel``) on one
   [1,2048,2048] frame through ``mdx_torch.tools.spatial_check.rank_check``:
   k = 1 rank over NCCL, then k = 4 ranks on the one card over gloo (NCCL
   refuses two ranks on one device), launched with every counter reset:
   ``qa_plan_spatial``'s body with the bench plan and ``qa_spatial``'s with
   denoise, CLAHE, TV and the noise guard; kernels 11 (``clahe_remap_ext``)
   and 12 (``tv_shard_step``, the blocked sharded TV step: s iterations a
   launch from s-wide halo slabs, then one rebuild) must launch on every
   rank, outputs finite; every call of kernels 11 and 12 (its blocked
   launches and its rebuild) and of kernel C's LUT stage (``clahe_luts``,
   the local LUTs) on rank 0 replayed against its plain version and the
   whole sharded TV solve run through the kernels and plain with equal
   iteration counts, its schedule printed (iterations a launch, step
   launches, at most ceil(iterations / s) + 1, flag reads, host round
   trips a solve) and its times taken
   (``mdx_torch.tools.time_tv_shard.rank_solves``); kernel 12's schedule
   cases at k = 4, in the same launch after the check, against the plain
   solve, bit for bit with equal counts (caps 1 .. 2s + 1 on the frame's
   first 512 rows, three copies of the frame that stop in different
   launches, blocks thinner than s); the gathered frame against k = 1 and against the
   dense ``qa_plan`` on the card within ``parity.breaches``, guard and pass
   flags equal; ms per ``qa_plan_spatial`` call (median of 5 synchronised
   reps in the ranks) with the backend and the host round trips per call;
   kernels 11 and 12 (a launch and the rebuild) and the LUT stage against
   their plain versions at the shard shape [1,512,2048] and at
   [1,2048,2048], with their bounds.
10. tiles  — the 2-D tile layout on the same frame: ``rank_check`` on a
   (sy, sx) = (2, 2) grid of four ranks on the one card over gloo (the
   ranks of phase 9's k = 4 launch, on their tiles, after the k = 4
   cases: one 4-rank start-up serves both layouts), with
   phase 9's requirements (kernels 11, 12 and C's LUT stage launched on
   every rank, rank 0's calls replayed, the whole 2-D TV solve kernels vs
   plain with equal counts and its schedule and times, the schedule cases
   on the grid (the caps on the frame's 512 x 512 corner), within ``parity.breaches`` of the dense ``qa_plan``), and
   against phase 9's k = 4 row blocks (flags equal); ms per call, host
   round trips, launch wall; kernels 11 and 12 (with column slabs) and the
   LUT stage at the tile [1,1024,1024].
11. probe  — kernel 13, the capability probe (``mdx_torch.tools.probe_nvcc``,
   the counterpart of ``tools/probe_mosaic.py``): 18 probes, one nvcc each,
   all started together, every one ``ok`` and equal to its plain version
   (exactly where the TPU tool checks ``array_equal``, to ``allclose``
   where it does; ``iota_select_matmul_deinterleave`` bit for bit, and its
   device time printed against its PyTorch call's); time per launch (CUDA
   events, and the device time from a profiler trace) against its bound,
   the plain version and one PyTorch call (CUDA events, and its device
   time from a trace).

12. cli    — the port's pipeline layer (``python -m mdx_torch``) on files
   written with the port's writer, ``MDX_DB_PATH`` in a temporary
   directory: 512^2 16-bit CT slices (noisy, low contrast, clipped, a
   blurred 12-bit phantom; BASELINE config 1) and one 2048^2 16-bit chest
   X-ray through ``main([...], device="cuda")``, deterministic and
   ``--autotune``, counters reset before each path: rc 0, the printed
   report equal to the file, a PNG that decodes, a DB row read back; B, U,
   C and 10 launched over these runs; every kernel call of the 512^2
   deterministic runs replayed against its plain version; every file
   (autotune: the 512^2 ones) on the card against the CPU by
   ``parity.compare_runs`` (what an input does not determine is printed,
   not required).  ``--batch`` on a 64-frame 512^2 12-bit series (explicit
   LE and RLE, ``--window``, ``--autotune``) and on a mixed directory
   (config 5: 8 CT at 512^2 with VOI windows, 4 chest X-rays at 2048^2,
   8 ultrasound frames 480 x 640 8-bit, two MONOCHROME1; raw, ``--window``,
   ``--autotune``): frame counts, finite records, B and 10 launched, a
   ``--resume`` run skips every frame, the 512^2 bucket on the card
   against the CPU within ``parity.breaches``.  Times beside the card:
   warm ``run_pipeline`` at 512^2 and 2048^2 split by phase, the process
   latency of ``python -m mdx_torch``, frames/s of the series (raw and
   autotune) and of the mixed directory, and a traced series run in
   chunks of 64 and 16 (``tools/cli_latency.py``).
13. spatial-cli — ``python -m mdx_torch --spatial`` on two 2048^2 16-bit
   slices written with the port's writer (noisy: the sharded denoise and
   the noise guard; low contrast, which clips at both ends once
   normalised: CLAHE, so kernel 11 and C's LUT stage), ``MDX_DB_PATH`` in
   a temporary directory.  Every run's launch goes through
   ``spatial_check.recorded_rank``: each rank's counters reset before the
   runner's rank body and read after it, rank 0's calls of kernel 11 and
   the LUT stage recorded and replayed against their plain versions.
   ``main([... "--spatial"], device="cuda")`` on each file (k = 1 over
   NCCL): one launch, rc 0, the printed report equal to the file, its DB
   row read back, the phase times (``tools/cli_latency.py``), and the
   run against the dense ``qa_deterministic`` on the card (issues, ops,
   noise guard equal; ``enhanced`` within 1e-4; metrics within
   ``parity.breaches``).  ``--autotune`` on the low-contrast file against
   the dense ``autotune`` (records and pick equal, scores within 2e-3,
   gamma and clip equal, ``enhanced`` within 1e-4), with ms a candidate.
   ``run_pipeline_spatial(n_space=(2, 2))`` on it: four gloo ranks on the
   one card (host staging, not scaling), its issues, ops and flags equal
   to the k = 1 run's and its frame within ``parity.breaches``.  Kernel 11
   and the LUT stage launched on every rank of each run that applied
   CLAHE, and rank 0's calls within ``KERNEL_TOL``.
14. data   — the data axis (``mdx_torch.parallel.batch`` and ``stream``,
   BASELINE config 3 across ranks; on the one card d = 2 is two gloo
   ranks sharing it: contention, not scaling), ``MDX_DB_PATH`` in a
   temporary directory:
   1. ``make_batch(63)`` at 512^2, padded to 64: ``qa_deterministic_sharded``,
      ``qa_plan_sharded`` (the bench plan) and ``detect_sharded`` at
      n_data = 1 (in this process, no launch), and their rank bodies at
      n_data = 2 in ONE launch (``tools/data_check.py``: ``launch.call_each``
      inside ``spatial_check.recorded_rank``): B, U, C, 10, T and 5
      launched on every rank, rank 0's calls of each replayed against the
      plain versions within ``KERNEL_TOL`` (T: equal iteration counts),
      outputs finite, n_data = 2 against n_data = 1 within
      ``parity.breaches`` (bit-equality printed);
   2. ``run_pipeline_batch`` on phase 12's 64-frame 512^2 12-bit series at
      n_data = 2 (the rank pool, started by the first run and reused by a
      second; each rank's share recorded as in 1.; B and 10 on every rank)
      against n_data = 1: issues and pass flags equal, metrics within
      ``parity.breaches``, ``"mesh"`` ``{"data": 2, "space": 1}``;
   3. ``stream_batches`` over 64 single-frame 512^2 files written with the
      port's writer, batches of 16, into ``qa_deterministic``: equal to
      decoding all first; frames/s of both, and the uploads on the copy
      stream that overlapped a kernel in one traced run;
   4. times: img/s of the three bodies at n_data = 1 and 2 (the slowest
      rank's median call), the launch walls and each rank's compute.
15. codecs — JPEG Lossless, JPEG-LS, DCT JPEG and JPEG 2000
   (``mdx_torch.io.jpegll``, ``jpegls``, ``jpegdct``, ``jpeg2k``, their
   entropy and EBCOT Tier-1 loops and PackBits in
   ``mdx_torch/csrc/host/codecs.cpp`` through ``mdx_torch.io.native``) and
   the transcoder (``mdx_torch.io.transcode``),
   ``MDX_DB_PATH`` in a temporary directory; phase 12's pixels (the four
   512^2 CT slices, the 2048^2 chest X-ray, the 64-frame series) written
   again with the port's writer in explicit LE, ``.4.70``, ``.4.80`` and
   ``.4.90``, the noisy slice at predictor 7 as ``.4.57`` and the blurred
   phantom at NEAR 2 as ``.4.81`` (the codec's frames, the UID rewritten;
   its decoded pixels in explicit LE as its twin), and the two committed
   ``.4.91`` codestreams of ``tests/torch_fixtures/j2k/`` (irreversible
   9/7, made by Pillow) wrapped as DICOM files: a 512^2 CT slice (its
   decoded pixels in explicit LE as its twin) and a 96 x 80 YBR_ICT
   colour image; the four committed DCT JPEG codestreams of
   ``tests/torch_fixtures/jpegdct/`` (Pillow's libjpeg and a test-only
   12-bit encoder) wrapped as DICOM files: a 512^2 8-bit slice with restart
   intervals, the same progressive, a 480 x 640 YBR_FULL_422 ultrasound
   frame (``.4.50``) and a 256^2 12-bit slice (``.4.51``), a 16-frame
   ``.4.50`` series of the two 512^2 streams, and config 5's mixed
   directory with the ultrasound frame as its 8 ultrasound files; each DCT
   file's twin is its transcode to explicit LE:
   1. the host library built from the checkout's source at first use: the
      compiler, its version and the build seconds;
   2. every lossless file's pixels bit-equal to its explicit-LE twin's; the
      ``.4.81`` file within 2 of its source and equal to its decode through
      the Python loops; one 512^2 frame of each lossless JPEG family
      encoded and decoded alike through the host loops and the Python
      loops; the 512^2 frame through JPEG 2000's host loops (bit-equal
      round trip), its 128^2 corner and the ``.4.91`` colour fixture
      through both JPEG 2000 loops alike; every DCT file's pixels equal to
      its twin's, each DCT fixture decoded alike through the host and
      Python loops, a 512^2 RLE fragment (PackBits) encoded and decoded
      alike through both; every host entry point used (``native.CALLS``);
   3. ``main([...], device="cuda")`` in three paths, counters reset before
      each and read after: ``codecs`` (the ``.4.57``, ``.4.70``, ``.4.80``
      and ``.4.81`` files), ``codecs_j2k`` (the ``.4.90`` and ``.4.91``
      files) and ``codecs_dct`` (the ``.4.50`` and ``.4.51`` files): every
      single file and its twin deterministic and
      ``--autotune``, ``--batch`` on the path's series (raw and
      ``--autotune``): rc 0, the report printed equal to the file, records
      finite; each run's records (issues, ops, status, pass flags) equal
      to its twin's, metrics within ``parity.breaches``, bit-equality
      printed; each ``.4.91`` file's deterministic run against its run on
      the CPU the same way; B, U, C and 10 launched in each path; the
      ``.4.70`` and ``.4.90`` blurred slices' kernel calls replayed against
      the plain versions (and the ``.4.50`` slice with restarts); the
      mixed directory with ``.4.50`` ultrasound under ``--batch --window``
      against its twin directory (path ``codecs_dct_mixed``);
      ``--spatial`` on the ``.4.70`` and ``.4.90`` chest X-rays at k = 1
      against the explicit-LE file's run;
   4. times beside the card and the host's CPU model and cores: ms a frame
      to encode and decode each family through the host loops at 512^2
      and 2048^2 (the JPEG 2000 decode split into Tier-1, inverse DWT and
      the rest), the lossless JPEG families' Python loops at 512^2, and
      JPEG 2000's host and Python loops at 128^2 (``tools/time_codecs.py``),
      frames/s of the series in explicit LE, ``.4.70``, ``.4.80`` and
      ``.4.90`` in turns, the warm ``run_pipeline`` of each syntax at 512^2
      and 2048^2 by phase (``decode`` holds the codec), each DCT fixture's
      decode split into the entropy loops, the IDCT and the rest, the
      transcoder's ms from explicit LE to each lossless target at 512^2
      and 2048^2 and from ``.4.50`` to explicit LE, the warm
      ``run_pipeline`` of the ``.4.50`` slice and ultrasound frame and
      their twins;
   5. for each (source syntax, target syntax) pair of the phase-15
      files, the smallest file of that syntax the transcoder accepts the
      target for (colour: explicit LE and deflated), transcoded on a pool
      of worker processes and read back pixel-equal to the source's
      decode.
16. serve  — the JSON API (``mdx_torch.serve``) on phase 12's four 512^2
   files, ``MDX_DB_PATH``, ``UPLOAD_DIR`` and ``OUTPUT_DIR`` in a temporary
   directory, no ``OPENAI_API_KEY``:
   1. ``python -m mdx_torch.serve.api`` as a subprocess on a free ``PORT``:
      ``GET /`` answered within 120 s, one upload run to ``completed``,
      then stopped; the seconds from start to the first answer and the
      cold run's ms from ``POST /api/run`` to ``completed``;
   2. the port's ``App`` on a free port in a thread of this process: the
      blurred slice uploaded, run and polled (counters reset before, read
      after: B, U, C and 10 launched; its kernel calls replayed against
      the plain versions), detail, report, logs and before/after answered;
      its DB row equal, field for field, to an in-process ``run_pipeline``
      of the uploaded file, the served PNG (``io.visuals.read_png``)
      bit-equal to that run's, ``POST /api/runs/<id>/chat`` 200 with the
      stored-data summary and both messages stored; warm runs' ms;
   3. the four files posted back to back (the executor's four workers run
      them at once): all ``completed``, each row equal to its serial
      ``run_pipeline`` row; the wall against four serial calls;
   4. ``{"genai": true}`` and ``{"genai": true, "autotune": true}``: both
      complete, their rows equal to the deterministic run's and to
      ``run_pipeline(autotune=True)``'s.
17. genai  — GenAI mode (``mdx_torch.genai``) in process with a scripted
   model installed in ``mdx_torch.genai.client`` (``GenAIScript``; no key,
   no network), ``MDX_DB_PATH`` in a temporary directory:
   1. ``run_pipeline(genai=True, max_iters=2)`` on phase 12's noisy 512^2
      slice (config 1) and its 2048^2 chest X-ray, counters reset before
      each: the planner's seed plan, two plans applied, validated and
      scored by the tuning agent, the final plan (denoise, CLAHE, unsharp,
      bilateral d = 5, TV weight 0.05) executed, the explanation; B, U, C,
      10, 5 and T launched, no fallback, 9 model calls, two records and
      one chosen, the report's GenAI sections and the DB row; every kernel
      call recorded and replayed against its plain version (T: equal
      iteration counts); the same script on the CPU: every field within
      ``parity.breaches`` with TV's allowance, the records' plans, the
      chosen record, the scores (``parity.SCORE_ATOL``), the best plan and
      the applied ops equal; the walls of the planner, tuning, execute and
      explainability phases;
   2. the 512^2 run with ``plan_only=True``: the planner's plan, nothing
      executed;
   3. ``python -m mdx_torch --input <512^2> --genai --max-iters 2`` in a
      subprocess with no key and no transport: rc 0, the deterministic
      report and main.py's ``WARNING: GenAI failed (planner failed: ...)``
      line;
   4. ms per ``tool_apply_enhancement`` (the final plan) and per
      ``tool_validate`` at 512^2 and 2048^2 (median of 5).
18. prime  — deploy-time priming (``mdx_torch.pipeline.prime``),
   ``MDX_DB_PATH`` in a temporary directory:
   1. ``prime([(512, 512)])``, ``prime_tuning([(512, 512)])`` and
      ``prime_spatial([(2048, 2048)])`` in this process (the last one
      launch of one rank over NCCL), counters reset before and read after:
      JAX's counts (8, 5 and 9), B, U, C, 10 and 11 launched (path
      ``prime``), every kernel call of the process replayed against its
      plain version and rank 0's calls of 11 and C's LUT stage too; each
      step's line and seconds printed;
   2. ``mdx_torch/`` copied into an empty temporary directory (so its
      ``build/`` starts empty) and ``python -m mdx_torch.pipeline.prime
      --shapes 512x512 --tuning`` run there in a new process: rc 0, both
      libraries built in the copy, every step line printed;
   3. the first ``python -m mdx_torch --input <512^2 .4.70 file>`` in the
      primed copy (its ``build/`` unchanged: names, sizes, mtimes) and in
      a second, unprimed copy (which builds both libraries): both walls
      beside the card.

The second-last line is one JSON object with a row per kernel (times at
16x2048^2, with the 32x512^2 times under ``by_size``; kernels 11 and 12 at
the shard shape [1,512,2048], with [1,2048,2048] and the 2-D tile under
``by_size`` (kernel 12: a launch of s iterations, the rebuild and a whole
solve at each), and the LUT stage's times under the CLAHE row's ``by_size``;
the probe's summed over its 18 kernels, each under ``by_probe``; the
select kernel's at [64, 512^2] and on the HH band under ``by_size``, its
``library_ms`` one ``torch.kthvalue`` call;
``bound_ms`` from this run's shapes, and for TV its iteration counts;
launches per path of phases 5-18, summed over the ranks in phases 9, 10,
13, 14, 15's ``--spatial`` runs and 18's ``prime_spatial``);
the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time

SOURCE = {"box_stats": "mdx_torch/csrc/box_stats.cu",
          "unsharp": "mdx_torch/csrc/unsharp.cu",
          "clahe": "mdx_torch/csrc/clahe.cu",
          "tv_chambolle": "mdx_torch/csrc/tv.cu",
          "bilateral": "mdx_torch/csrc/bilateral.cu",
          "wavelet_denoise": "mdx_torch/csrc/wavelet.cu",
          "clahe_remap_ext": "mdx_torch/csrc/clahe.cu",
          "tv_shard_step": "mdx_torch/csrc/tv.cu",
          "select": "mdx_torch/csrc/select.cu",
          "capability_probe": "mdx_torch/csrc/probes/"}
_PK = "mdx/ops/pallas_kernels.py"
REPLACES = {"box_stats": [f"{_PK}:792"],
            "unsharp": [f"{_PK}:1126", f"{_PK}:1388"],
            "clahe": [f"{_PK}:371", f"{_PK}:654"],
            "tv_chambolle": [f"{_PK}:511", f"{_PK}:906"],
            "bilateral": [f"{_PK}:1229", f"{_PK}:1301"],
            "wavelet_denoise": [f"{_PK}:1549"],
            "clahe_remap_ext": ["mdx/parallel/clahe_sp.py:112"],
            "tv_shard_step": ["mdx/parallel/tv_sp.py:92", f"{_PK}:906"],
            # none: the JAX package's order statistics are a binary search
            # in plain JAX (mdx/ops/quantile.py)
            "select": [],
            "capability_probe": ["tools/probe_mosaic.py:60"]}
# each counter's wrapper where the two names differ
WRAPPER = {"select": "select_ranks"}
# the sharded path's kernels (phases 9-10); the probe is phase 11's; the
# others serve phases 3-8 (the select kernel serves every metric pass's
# percentiles and medians)
SPATIAL_KERNELS = ("clahe_remap_ext", "tv_shard_step")
DENSE_KERNELS = tuple(k for k in SOURCE
                      if k not in SPATIAL_KERNELS + ("capability_probe",))
SIZE_N = 32
BIG, CONFIG2_N, QA_BIG_N = 2048, 64, 16
CHUNK_N = 64            # a CT chunk's frames (the batch runner's)
REPS = 7
TUNE_ISSUES = ["noise", "blur"]
TUNE_BATCH_N, INGEST_N = 4, 64
# the metric pass's percentiles of an image (core/metrics.py image_stats),
# the select kernel's ranks in the kernel rows
METRIC_QS = (5.0, 25.0, 75.0, 95.0)
# the tuning sweep's scores, card against CPU.  Each is a weighted sum of
# validation fields whose float32 sums over the 512^2 pixels run in another
# order on the card than on the CPU; that moves a score of about -10 by
# 1.3e-5 to 3.1e-5 (the qa_plan and qa_deterministic slice of phase 4 and
# this sweep, measured on an H100), 20 to 30 float32 ulp.  1e-4 bounds that
# and stays 10x inside parity.SCORE_ATOL, the slice's score tolerance.
TUNE_SCORE_ATOL = 1e-4

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per pixel each kernel's function needs, counted from
# its arithmetic (TV: per pixel and iteration; bilateral: see _bound): box
# stats 7x7 and 16x16 sums of x and x^2 both ways, scales, variances, sqrt,
# and the two reduction passes;
# unsharp 25-tap rows and columns and the combine; CLAHE the bin index,
# the clipped LUT per bin (256 bins per 16x16 tile) and the 4-LUT blend;
# wavelet denoise, over all levels (each level works on a quarter of the
# pixels of the one before, 4/3 in all): analysis 6 per pixel (24 per 2x2
# quad) -> 8, the bands' squares and sums 1.5 -> 2, the soft shrink 3 -> 4
# and synthesis 6 -> 8; the sharded CLAHE remap the bin index (4), the two
# tile coordinates and their weights (10) and the 4-LUT blend (11); a
# sharded TV iteration the dense TV iteration's 23 (per pixel and
# iteration); CLAHE's LUT stage alone the bin index and its count (5) and
# the clip, redistribution, scan and scale of 256 bins per 16x16 tile (6).
OPS_PER_PIXEL = {"box_stats": 130, "unsharp": 103, "clahe": 47,
                 "tv_chambolle": 23, "wavelet_denoise": 22,
                 "clahe_remap_ext": 25, "tv_shard_step": 23,
                 "clahe_luts": 11}
SPATIAL_SIZE, SPATIAL_K, SPATIAL_2D = 2048, 4, (2, 2)


class SmokeFailure(Exception):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _bench_plan(device):
    from mdx_torch.tools import bench_plan

    return bench_plan(device)


def _sync_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _median_ms(torch, fn, reps: int) -> tuple[float, list[float]]:
    """Median ms of ``reps`` synchronised calls on the host clock, after one
    warm-up, and all the times."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _plain_versions():
    from mdx_torch.core import metrics as M
    from mdx_torch.ops import bilateral as B
    from mdx_torch.ops import clahe as C
    from mdx_torch.ops import filters as F
    from mdx_torch.ops import quantile as Q
    from mdx_torch.ops import tv as T
    from mdx_torch.ops import wavelet as W

    def wavelet_plain(x, sigma, soft, levels):
        return W.denoise_wavelet_plain(x, sigma, wavelet_levels=levels,
                                       soft_mask=soft)

    return {"box_stats": M._lv_box_stats_plain,
            "unsharp": F.unsharp_mask_plain,
            "clahe": C.clahe_plain,
            "tv_chambolle": T.tv_chambolle_plain,
            "bilateral": B.bilateral_plain,
            "wavelet_denoise": wavelet_plain,
            "select": Q.select_ranks_plain}


def _wrapper(kernels, name: str):
    """The kernel wrapper counted as ``name``."""
    return getattr(kernels, WRAPPER.get(name, name))


def _bound(torch, name: str, args, result) -> tuple[float, str]:
    """(least ms the card could take for this call, "bytes" or
    "operations"): each input read once and each output written once over
    the memory rate, against the operations over the float32 peak (the
    select kernel: no float operations, its rows read once and its [N, T]
    order statistics written)."""
    if name == "select":
        moved = 4 * (args[0].numel() + result.numel())
        return moved / HBM_BYTES_PER_S * 1e3, "bytes"
    n, h, w = args[0].shape
    px = n * h * w
    moved = sum(a.numel() * a.element_size() for a in args
                if torch.is_tensor(a))
    if name == "box_stats":
        moved += 3 * 4 * n
    else:
        moved += 4 * px + (4 * n if name == "tv_chambolle" else 0)
    if name == "bilateral":
        # the weights a pixel needs: wgt_{-o}(p) = wgt_o(p - o) bit for bit,
        # so (d^2 + 1) / 2 of them (the forward offsets and the centre) at 5
        # operations each (difference, square, scale, exp, times the spatial
        # weight); then 3 a tap (w * s and the two sums) and the final add and
        # divide
        d2 = args[1] ** 2
        ops = px * (5 * (d2 + 1) // 2 + 3 * d2 + 2)
    elif name == "tv_chambolle":
        ops = h * w * int(result[1].sum()) * OPS_PER_PIXEL[name]
    else:
        ops = px * OPS_PER_PIXEL[name]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def _recording(torch, kernels, calls: list, when=lambda: True):
    """Record (name, args, kwargs) of every kernel wrapper call made while
    ``when()`` is true, with the tensors cloned, while the wrappers run as
    usual; each call under its counter's name."""
    originals = {k: _wrapper(kernels, k) for k in kernels.LAUNCHES}

    def recorder(name, fn):
        def call(*args, **kw):
            if when():
                calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                          else a for a in args), dict(kw)))
            return fn(*args, **kw)
        return call

    for k, fn in originals.items():
        setattr(kernels, WRAPPER.get(k, k), recorder(k, fn))
    try:
        yield
    finally:
        for k, fn in originals.items():
            setattr(kernels, WRAPPER.get(k, k), fn)


class KernelCheck:
    """Runs a kernel and its plain version on the same inputs, holds them to
    ``parity.KERNEL_TOL`` (and TV's iteration counts to equality), prints
    one line per comparison and keeps the worst error per kernel."""

    def __init__(self, torch, kernels, parity):
        self.torch, self.kernels, self.parity = torch, kernels, parity
        self.plain = _plain_versions()
        self.errs = {k: 0.0 for k in kernels.LAUNCHES}
        self.failed: list[str] = []

    def compare(self, label: str, name: str, got, want) -> None:
        self.torch.cuda.synchronize()
        extra = ""
        if name == "tv_chambolle":
            (got, it_k), (want, it_p) = got, want
            extra = (f"; iterations kernel {it_k.tolist()}, "
                     f"plain {it_p.tolist()}")
            if it_k.tolist() != it_p.tolist():
                self.failed.append(f"{label} {name}: iteration counts differ")
        err, ok = self.parity.kernel_parity(name, got, want)
        self.errs[name] = max(self.errs[name], err)
        rtol, atol = self.parity.KERNEL_TOL[name]
        print(f"kernel parity {label} {name}: max|d| {err!r} "
              f"(tol {atol} + {rtol}*|plain|){extra}")
        if not ok:
            self.failed.append(f"{label} {name}: max|d| {err!r}")

    def run(self, label: str, name: str, args, kw=None) -> None:
        kw = kw or {}
        self.compare(label, name, _wrapper(self.kernels, name)(*args, **kw),
                     self.plain[name](*args, **kw))

    def replay(self, label: str, calls: list) -> None:
        """Each recorded main-path call against the plain version."""
        seen: dict[str, int] = {}
        for k, args, kw in calls:
            seen[k] = seen.get(k, 0) + 1
            shape = "x".join(map(str, args[0].shape))
            self.run(f"{label} call {seen[k]} [{shape}]", k, args, kw)
        print(f"replayed {label}: {seen}")

    def require_ok(self) -> None:
        _require(not self.failed,
                 "kernel off its plain version: " + "; ".join(self.failed))


def _select_args(flat, qs=METRIC_QS):
    """The select kernel's arguments for the percentiles ``qs`` of each row
    of [N, M] ``flat``: the rows and the ranks ``percentiles_exact`` reads."""
    from mdx_torch.ops import quantile as Q

    m = flat.shape[1]
    return flat.contiguous(), Q.select_targets(Q._plan(qs, m)[0], m)


def _args_for(torch, x, params):
    """Each kernel's arguments at the bench plan's parameters (the wavelet
    denoise: sigma from the plain MAD estimate, soft on every image; the
    select kernel: the metric percentiles of each image)."""
    from mdx_torch.ops import wavelet as W

    full = lambda v: torch.full((x.shape[0],), float(v), device=x.device)  # noqa: E731
    return {
        "box_stats": (x,),
        "unsharp": (x, full(params["unsharp_radius"]),
                    full(params["unsharp_amount"])),
        "clahe": (x, full(params["clahe_clip_limit"]),
                  params["clahe_tile_size"]),
        "tv_chambolle": (x, full(params["tv_denoise_weight"]), 2e-4, 200),
        "bilateral": (x, params["bilateral_d"],
                      full(params["bilateral_sigma_color"]),
                      full(params["bilateral_sigma_space"])),
        "wavelet_denoise": (x, _mad_sigma(x),
                            torch.ones(x.shape[0], dtype=torch.bool,
                                       device=x.device),
                            W.default_levels(x.shape[-2:])),
        "select": _select_args(x.reshape(x.shape[0], -1)),
    }


def _mad_sigma(x):
    """The plain version's per-image MAD sigma of ``x`` (finest db1 HH)."""
    from mdx_torch.ops import wavelet as W

    return W.mad_sigma_from_hh(W.dwt2(x, "db1")[1][2]).contiguous()


def _wavelet_cases(torch, check, x, label: str) -> None:
    """The wavelet kernel against its plain version on ``x``: soft, hard and
    a mixed soft mask with sigma given, and ``sigma=None`` (the MAD sigma
    from the kernel's own finest HH) through ``denoise_wavelet``."""
    from mdx_torch.ops import wavelet as W

    n = x.shape[0]
    levels = W.default_levels(x.shape[-2:])
    sigma = _mad_sigma(x)
    masks = {"soft": torch.ones(n, dtype=torch.bool, device=x.device),
             "hard": torch.zeros(n, dtype=torch.bool, device=x.device),
             "mixed": torch.arange(n, device=x.device) % 2 == 0}
    for mname, mask in masks.items():
        check.run(f"{label} {mname}", "wavelet_denoise",
                  (x, sigma, mask, levels))
    check.compare(f"{label} mixed sigma=None via denoise_wavelet",
                  "wavelet_denoise",
                  W.denoise_wavelet(x, soft_mask=masks["mixed"]),
                  W.denoise_wavelet_plain(x, soft_mask=masks["mixed"]))


def _repeat_equal(torch, label: str, fn) -> None:
    """A kernel call run twice on the same inputs gives equal bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    _require(torch.equal(a, b), f"{label}: two runs differ")
    print(f"repeat {label}: two runs bit-equal")


def _clahe_cases(torch, kernels, check, dev) -> None:
    """Kernel C (phase 3) on tile sizes 8, 12, 16, 32, extents that are not
    multiples of the tile, single-tile images and adversarial histograms
    (every pixel in one bin, half the image clipped, flat): the kernel and
    its LUT stage against their plain versions, two runs bit-equal."""
    from mdx_torch.ops import clahe as C

    clip = torch.tensor([0.01, 0.02, 0.05], device=dev)
    for shape, t in (((3, 72, 60), 12), ((3, 128, 96), 32), ((3, 37, 83), 8),
                     ((3, 16, 16), 16), ((3, 60, 52), 16), ((3, 4, 4), 16),
                     ((3, 512, 512), 16), ((3, 2048, 2048), 16)):
        for data in ("wavy", "adversarial"):
            x = _wavy(torch, 29, *shape, "cpu")
            if data == "adversarial":
                n, h, w = shape
                x[0] = 0.3
                x[1, : h // 2] = -0.5
                x[1, h // 2:, : w // 3] = 1.7
                x[2] = 0.5
                x[2, h // 3: h // 3 + 8, w // 3: w // 3 + 8] = 0.99
            x = x.to(dev)
            label = "[" + ",".join(map(str, shape)) + f"] t {t} {data}"
            check.run(label, "clahe", (x, clip, t))
            _repeat_equal(torch, f"clahe {label}",
                          lambda x=x, t=t: kernels.clahe(x, clip, t))
            if shape[1] % t == 0 and shape[2] % t == 0:
                check.compare(f"{label} LUT stage", "clahe",
                              kernels.clahe_luts(x, clip, t),
                              C.clahe_luts_plain(torch.clamp(x, 0.0, 1.0),
                                                 clip, t))


def _wavelet_edge_cases(torch, kernels, check, dev) -> None:
    """Kernel 10 (phase 3) on the coarse stages at 512^2 (16 x 16, one
    level) and 2048^2 (64 x 64, three), a non-square 5 + 2, one-level and
    three-level stages alone: with sigma 0 the transform pair equals the
    plain version bit for bit; sigma given and sigma None (through
    ``denoise_wavelet``) within KERNEL_TOL and bit-equal on two runs; a
    zero sigma and a flat image."""
    from mdx_torch.ops import wavelet as W

    for shape, levels in (((2, 512, 512), 6), ((1, 2048, 2048), 8),
                          ((2, 256, 512), 7), ((2, 6, 10), 1),
                          ((2, 24, 40), 3), ((2, 64, 128), 6)):
        x = _wavy(torch, 30, *shape, dev)
        n = shape[0]
        mask = torch.arange(n, device=dev) % 2 == 0
        label = "[" + ",".join(map(str, shape)) + f"] levels {levels}"
        zero = torch.zeros(n, device=dev)
        got = kernels.wavelet_denoise(x, zero, mask, levels)
        want = W.denoise_wavelet_plain(x, zero, wavelet_levels=levels,
                                       soft_mask=mask)
        check.compare(f"{label} sigma 0", "wavelet_denoise", got, want)
        _require(torch.equal(got, want),
                 f"wavelet {label}: transform not bit-equal to plain")
        sigma = torch.linspace(0.03, 0.09, n, device=dev)
        check.run(f"{label} mixed", "wavelet_denoise",
                  (x, sigma, mask, levels))
        _repeat_equal(torch, f"wavelet {label} sigma given",
                      lambda x=x, s=sigma, m=mask, lv=levels:
                      kernels.wavelet_denoise(x, s, m, lv))
        check.compare(f"{label} sigma=None via denoise_wavelet",
                      "wavelet_denoise",
                      W.denoise_wavelet(x, wavelet_levels=levels,
                                        soft_mask=mask),
                      W.denoise_wavelet_plain(x, wavelet_levels=levels,
                                              soft_mask=mask))
        _repeat_equal(torch, f"wavelet {label} sigma None",
                      lambda x=x, m=mask, lv=levels: W.denoise_wavelet(
                          x, wavelet_levels=lv, soft_mask=m))
    x = _wavy(torch, 14, 3, 64, 64, dev)
    x[1] = 0.5
    check.run("[3,64,64] zero sigma, flat image", "wavelet_denoise",
              (x, torch.tensor([0.0, 0.05, 0.05], device=dev),
               torch.tensor([True, False, True], device=dev), 3))


def _wavy(torch, seed: int, n: int, h: int, w: int, dev):
    """A seeded [n,h,w] batch: a smooth pattern plus Gaussian noise, clipped
    to [0,1] (the card tests' ``_batch``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = np.clip(base[None] + rng.normal(0, 0.1, (n, h, w)), 0.0, 1.0)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _exact(torch, check, label: str, name: str, got, want) -> None:
    """A kernel's output equal to its plain version's bit for bit, NaN in the
    same places (the non-finite cases, which ``KernelCheck.compare`` cannot
    hold: NaN - NaN is NaN); max|d| over the finite values goes to the
    kernel's row."""
    torch.cuda.synchronize()
    nan_p = torch.isnan(want)
    same = (torch.equal(torch.isnan(got), nan_p)
            and torch.equal(got[~nan_p], want[~nan_p]))
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got[fin].double() - want[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    check.errs[name] = max(check.errs[name], err)
    print(f"kernel parity {label} {name}: max|d| {err!r} over finite values, "
          f"{int(nan_p.sum())} NaN in plain, bit-equal {same}")
    if not same:
        check.failed.append(f"{label} {name}: not bit-equal (max|d| {err!r})")


# every r_eff = floor(4 sigma + 0.5) from 0 to 12, and one above 12
UNSHARP_SIGMAS = [0.0, 0.1, 0.25, 0.5, 0.8, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25,
                  2.5, 2.75, 3.0, 3.5]


def _unsharp_cases(torch, kernels, check, dev) -> None:
    """Kernel U (phase 3): every r_eff from 0 to 12 and one above (the
    support sized from the taps) at 150x300, 512^2, 1x200 and 150x1; 1x1,
    images smaller than a tile and non-square ones; NaN and +inf pixels 5
    to 12 beyond a tile edge (past the support of radius 1.0 and 0.8) and
    NaN taps, through the 25-tap path; each equal to the plain version bit
    for bit, two runs bit-equal."""
    from mdx_torch.ops import filters as F

    n = len(UNSHARP_SIGMAS)
    rad = torch.tensor(UNSHARP_SIGMAS, device=dev)
    amt = torch.linspace(0.3, 1.5, n, device=dev)
    for h, w in ((150, 300), (512, 512), (1, 200), (150, 1), (1, 1),
                 (20, 30), (150, 140)):
        x = _wavy(torch, 31, n, h, w, dev)
        label = f"[{n},{h},{w}] every support"
        _exact(torch, check, label, "unsharp", kernels.unsharp(x, rad, amt),
               F.unsharp_mask_plain(x, rad, amt))
        _repeat_equal(torch, f"unsharp {label}",
                      lambda x=x: kernels.unsharp(x, rad, amt))
    rad3 = torch.tensor([1.0, 0.8, float("nan")], device=dev)
    amt3 = torch.tensor([0.6, 1.0, 0.6], device=dev)
    for value in (float("nan"), float("inf")):
        x = _wavy(torch, 32, 3, 150, 300, "cpu")
        for img, i, j in ((0, 30, 133), (0, 75, 200), (1, 100, 119),
                          (1, 149, 299), (0, 10, 10), (2, 70, 70)):
            x[img, i, j] = value
        x = x.to(dev)
        label = f"[3,150,300] {value} pixels, NaN taps"
        got = kernels.unsharp(x, rad3, amt3)
        _exact(torch, check, label, "unsharp", got,
               F.unsharp_mask_plain(x, rad3, amt3))
        _exact(torch, check, label + " second run", "unsharp", got,
               kernels.unsharp(x, rad3, amt3))


def _bilateral_cases(torch, kernels, check, dev) -> None:
    """Kernel 5 (phase 3): d = 1, 3, 5, 7 and 9 on heights and widths of 1
    and 2 (reflection with n = 1 and 2), a non-square shape and 512^2 with
    per-image sigmas; sigma_color 0, sigma_space 0 and NaN pixels; each
    equal to the plain version bit for bit, two runs bit-equal."""
    from mdx_torch.ops import bilateral as B

    for d in (1, 3, 5, 7, 9):
        for shape in ((1, 1, 40), (1, 40, 1), (1, 2, 37), (1, 37, 2),
                      (1, 1, 1), (1, 2, 2), (3, 129, 77), (2, 512, 512)):
            x = _wavy(torch, 33, *shape, dev)
            n = shape[0]
            sc = torch.linspace(0.03, 0.2, n, device=dev)
            ss = torch.linspace(0.05, 0.5, n, device=dev)
            label = "[" + ",".join(map(str, shape)) + f"] d {d}"
            _exact(torch, check, label, "bilateral",
                   kernels.bilateral(x, d, sc, ss),
                   B.bilateral_plain(x, d, sc, ss))
        x = _wavy(torch, 34, 4, 150, 140, "cpu")
        x[2, 33, 40] = float("nan")
        x[2, 0, 0] = float("nan")
        x = x.to(dev)
        sc = torch.tensor([0.0, 0.07, 0.05, 0.2], device=dev)
        ss = torch.tensor([0.05, 0.0, 0.3, 0.5], device=dev)
        label = f"[4,150,140] d {d} sigma 0, NaN pixels"
        got = kernels.bilateral(x, d, sc, ss)
        _exact(torch, check, label, "bilateral", got,
               B.bilateral_plain(x, d, sc, ss))
        _exact(torch, check, label + " second run", "bilateral", got,
               kernels.bilateral(x, d, sc, ss))


def _tv_cases(torch, kernels, check, dev) -> None:
    """Kernel T's blocked schedule against the plain version (phase 3):
    counts equal and pixels within KERNEL_TOL in every case."""
    s = kernels.tv_steps()

    def case(label, x, w, eps=2e-4, max_iter=200):
        got = kernels.tv_chambolle(x, w, eps, max_iter)
        solve = dict(kernels.TV_LAST_SOLVE)
        want = check.plain["tv_chambolle"](x, w, eps, max_iter)
        check.compare(label, "tv_chambolle", got, want)
        print(f"  schedule: {solve['steps']} iterations a launch, "
              f"{solve['launches']} launches, {solve['host_reads']} host "
              f"flag reads")
        return got[1].tolist()

    x = _wavy(torch, 6, 2, 32, 32, dev)
    w2 = torch.full((2,), 0.05, device=dev)
    for cap in range(1, 2 * s + 2):
        it = case(f"tv [2,32,32] eps 0 cap {cap} (last launch ends at "
                  f"offset {(cap - 1) % s})", x, w2, 0.0, cap)
        _require(it == [cap, cap], f"tv cap {cap}: counts {it}")
    x = _wavy(torch, 7, 1, 40, 56, dev).repeat(3, 1, 1)
    it = case("tv [3,40,56] mixed stops", x,
              torch.tensor([0.01, 0.03, 0.5], device=dev))
    launches = sorted({(c - 1) // s for c in it})
    print(f"  stops in launches {launches} of {s} iterations")
    _require(len(launches) == 3, f"tv mixed stops: launches {launches}")
    w3 = torch.tensor([0.05, 0.1, 0.02], device=dev)
    for shape in ((2, 5, 7), (3, 33, 129), (2, 1024, 1100)):
        label = "tv [" + ",".join(map(str, shape)) + "]"
        case(label, _wavy(torch, 5, *shape, dev), w3[:shape[0]])


def _pass_rows(torch, x, static, dyn, card: str, trace: bool) -> None:
    """The pass's rows (``tools/profile_pass.py``) at ``x``'s shape, and
    with ``trace`` the idle share of one traced ``qa_plan``."""
    from mdx_torch.tools import profile_pass as PP

    label = ",".join(map(str, x.shape))
    for row, ms in PP.phases(x, static, dyn, PP.REPS,
                             only=("qa_plan total", "image_stats",
                                   "op tv_denoise")):
        print(f"pass [{label}] {row} on {card}: {ms!r} ms (median of "
              f"{PP.REPS})")
    if trace:
        t = PP.traced_pass(x, static, dyn,
                           PP.ROOT / "build" / "chip_smoke_trace.json")
        print(f"pass [{label}] traced qa_plan on {card}: wall "
              f"{t['wall_us'] / 1e3!r} ms, {len(t['kernels'])} device "
              f"kernels, busy {t['busy_us'] / 1e3!r} ms, idle share "
              f"{1 - t['busy_us'] / t['wall_us']!r}")


def _require_finite(label: str, flat: dict, n: int, hw: int) -> None:
    _require(flat["enhanced"].shape == (n, hw, hw),
             f"{label}: enhanced shape {flat['enhanced'].shape}")
    _require(flat["score"].shape == (n,), f"{label}: score shape")
    for k, v in flat.items():
        _require(v.dtype == bool or k.endswith("psnr")
                 or bool(((v == v) & (abs(v) != math.inf)).all()),
                 f"{label}: non-finite values in {k}")
    print(f"{label} [{n},{hw},{hw}]: finite, mean score "
          f"{float(flat['score'].mean())!r}")


def _time_kernels(torch, kernels, check, x, params, card: str,
                  cases=None) -> dict:
    """Each kernel (or only ``cases``, {kernel: arguments}) against its
    plain version on ``x`` (plain, kernel, kernel, plain; CUDA events),
    outputs compared; per kernel: ms, plain_ms, bound_ms, bound_by (and
    TV's iterations; for the select kernel library_ms, one
    ``torch.kthvalue`` call for the first of its ranks)."""
    label = "x".join(map(str, x.shape))
    out = {}
    for k, args in (cases or _args_for(torch, x, params)).items():
        outs = {}

        def kern(k=k, args=args):
            outs["kernel"] = _wrapper(kernels, k)(*args)

        def plain(k=k, args=args):
            outs["plain"] = check.plain[k](*args)

        reps = 3 if k == "tv_chambolle" else 20
        p1 = _sync_ms(torch, plain, reps)
        k1 = _sync_ms(torch, kern, reps)
        k2 = _sync_ms(torch, kern, reps)
        p2 = _sync_ms(torch, plain, reps)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound_ms, bound_by = _bound(torch, k, args, outs["kernel"])
        print(f"time [{label}] {k} on {card}: kernel {ms!r} ms "
              f"({k1!r}, {k2!r}), plain {plain_ms!r} ms ({p1!r}, {p2!r}), "
              f"bound {bound_ms!r} ms ({bound_by})")
        check.compare(f"[{label}] raw batch", k, outs["kernel"],
                      outs["plain"])
        out[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by}
        if k == "select":
            flat, ranks = args
            lib_ms = _sync_ms(torch, lambda: torch.kthvalue(flat, ranks[0],
                                                            dim=-1), 3)
            out[k]["library_ms"] = lib_ms
            print(f"  select [{label}]: {len(ranks)} ranks, torch.kthvalue "
                  f"(one rank) {lib_ms!r} ms")
        if k == "tv_chambolle":
            iters = outs["kernel"][1].tolist()
            solve = kernels.TV_LAST_SOLVE
            out[k].update(iterations=iters, steps=solve["steps"],
                          launches_per_solve=solve["launches"],
                          host_reads=solve["host_reads"],
                          ms_per_iteration=ms / max(iters))
            print(f"  tv [{label}]: {solve['steps']} iterations a launch, "
                  f"iterations {iters}, {ms / max(iters)!r} ms per "
                  f"iteration, {solve['launches']} launches, "
                  f"{solve['host_reads']} host flag reads per solve")
        del outs
    check.require_ok()
    return out


def _run_path(torch, kernels, label: str, fn):
    """``fn()`` with every launch counter reset just before and read just
    after; returns (result, launches).  Prints the launches and the wall
    seconds of ``fn``."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches in {label}: {launches} "
          f"({time.perf_counter() - t0:.1f} s)")
    return res, launches


@contextlib.contextmanager
def _tune_scores(tuning, seen: list):
    """Appends the raw scores each ``tuning.autotune`` call hands to
    ``plan_records`` (its records round them to 4 places) to ``seen``."""
    inner = tuning.plan_records

    def rec(cands, ops, tile, scores, *a, **kw):
        seen.append(scores.copy())
        return inner(cands, ops, tile, scores, *a, **kw)

    tuning.plan_records = rec
    try:
        yield
    finally:
        tuning.plan_records = inner


def _check_sweep(label: str, enhanced, scores, chosen: int, shape) -> None:
    """A sweep's outputs: the enhanced pick(s) of ``shape`` and finite, the
    scores finite, ``chosen`` records marked chosen per frame."""
    import numpy as np

    _require(tuple(enhanced.shape) == tuple(shape),
             f"{label}: enhanced shape {tuple(enhanced.shape)}")
    _require(bool(np.isfinite(enhanced).all()), f"{label}: non-finite image")
    _require(bool(np.isfinite(scores).all()), f"{label}: non-finite scores")
    _require(chosen == (1 if len(shape) == 2 else shape[0]),
             f"{label}: {chosen} chosen records")
    print(f"{label}: finite, best score(s) "
          f"{np.max(np.reshape(scores, (-1, scores.shape[-1])), 1).tolist()}")


def _phase_tuning(torch, kernels, parity, check, paths: dict, card: str,
                  dev) -> None:
    """Phase 7: the tuning sweep at full size (module doc)."""
    import numpy as np

    from mdx_torch.core import tuning
    from mdx_torch.tools import make_batch

    t7 = time.perf_counter()
    img512 = make_batch(1)[0]
    img2048 = make_batch(1, BIG, seed=1)[0]
    frames = make_batch(TUNE_BATCH_N, seed=2)
    tuned = ("box_stats", "clahe", "unsharp", "wavelet_denoise")

    # 7.1 the three sweeps, counters reset before each
    calls: list = []
    seen: list = []
    with _recording(torch, kernels, calls), _tune_scores(tuning, seen):
        (plan, best_img, recs), paths["autotune_512"] = _run_path(
            torch, kernels, "autotune [1,512,512] (27 lanes)",
            lambda: tuning.autotune(img512, TUNE_ISSUES, device=dev))
    card_scores = seen[-1]
    _check_sweep("autotune 512^2", best_img, card_scores,
                 sum(r.chosen for r in recs), img512.shape)
    (_, big_img, big_recs), paths["autotune_2048"] = _run_path(
        torch, kernels, f"autotune [1,{BIG},{BIG}] (27 lanes)",
        lambda: tuning.autotune(img2048, TUNE_ISSUES, device=dev))
    _check_sweep(f"autotune {BIG}^2", big_img,
                 np.array([r.score for r in big_recs]),
                 sum(r.chosen for r in big_recs), img2048.shape)
    issues_per = [TUNE_ISSUES] * TUNE_BATCH_N
    (b_plans, b_imgs, b_scores), paths["autotune_batch_4x512"] = _run_path(
        torch, kernels, f"autotune_batch [{TUNE_BATCH_N},512,512] "
        f"({TUNE_BATCH_N * 27} lanes)",
        lambda: tuning.autotune_batch(frames, issues_per, device=dev))
    _check_sweep("autotune_batch 4x512^2", b_imgs, b_scores, len(b_plans),
                 frames.shape)
    for p in ("autotune_512", "autotune_2048", "autotune_batch_4x512"):
        for k in tuned:
            _require(paths[p][k] > 0, f"kernel {k} was not launched by {p}")
    check.replay("autotune 512^2", calls)
    del calls
    check.require_ok()

    # 7.2 the 512^2 sweep, card against CPU
    t0 = time.perf_counter()
    with _tune_scores(tuning, seen):
        c_plan, c_img, c_recs = tuning.autotune(img512, TUNE_ISSUES,
                                                device="cpu")
    cpu_scores = seen[-1]
    d_scores = float(np.abs(card_scores.astype(np.float64)
                            - cpu_scores).max())
    i_card, i_cpu = int(np.argmax(card_scores)), int(np.argmax(cpu_scores))
    print(f"autotune 512^2 card vs cpu: max|d score| {d_scores!r}, best "
          f"card {i_card} cpu {i_cpu} ({time.perf_counter() - t0:.1f} s)")
    _require(d_scores <= TUNE_SCORE_ATOL,
             f"autotune scores card vs cpu {d_scores!r}")
    if i_card != i_cpu:
        # a tie decided by a last-ulp difference: the two candidates' scores
        # must be within the tolerance of each other on both sides
        for side, sc in (("card", card_scores), ("cpu", cpu_scores)):
            gap = abs(float(sc[i_card]) - float(sc[i_cpu]))
            print(f"  tie on the {side}: scores {float(sc[i_card])!r} and "
                  f"{float(sc[i_cpu])!r}, gap {gap!r}")
            _require(gap <= TUNE_SCORE_ATOL,
                     f"autotune best differs card {i_card} cpu {i_cpu}")
    else:
        _require(plan.params == c_plan.params, "autotune plans differ")
        bad = parity.breaches({"enhanced": best_img[None]},
                              {"enhanced": c_img[None]}, tv_ran=False)
        print(f"autotune 512^2 picked image card vs cpu: max|d| "
              f"{float(np.abs(best_img - c_img).max())!r}, breaches "
              f"{len(bad)}")
        for line in bad:
            print("  " + line)
        _require(not bad, "autotune picked image: card and CPU disagree")

    # 7.3 times
    for label, fn, reps in (
            ("autotune [1,512,512]",
             lambda: tuning.autotune(img512, TUNE_ISSUES, device=dev), REPS),
            (f"autotune [1,{BIG},{BIG}]",
             lambda: tuning.autotune(img2048, TUNE_ISSUES, device=dev), 5),
            (f"autotune_batch [{TUNE_BATCH_N},512,512]",
             lambda: tuning.autotune_batch(frames, issues_per, device=dev),
             REPS)):
        med, times = _median_ms(torch, fn, reps)
        print(f"{label} on {card}: median {med!r} ms per sweep of {reps} "
              f"reps (min {min(times)!r}, max {max(times)!r})")
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")


def _ingest_stack():
    """64 frames of 512^2 as stored 12-bit uint16 with a CT-like rescale
    (slope 1, intercept -1024), and the per-frame float32 scalars of
    ``normalize_ingest`` as the JAX package's batch runner builds them for
    a stack without a stored window: (raw, scalars)."""
    import numpy as np

    from mdx_torch.tools import make_batch

    raw = np.rint(make_batch(INGEST_N, seed=3) * 4095.0).astype(np.uint16)
    n = raw.shape[0]
    gmin, gmax = float(raw.min()) - 1024.0, float(raw.max()) - 1024.0
    full = lambda v: np.full(n, v, np.float32)  # noqa: E731
    # slope, intercept, mono1, gmax, use_window, wlo, wden, nlo, nhi
    return raw, (full(1.0), full(-1024.0), full(0.0), full(gmax), full(0.0),
                 full(0.0), full(1.0), full(gmin), full(gmax))


def _phase_ingest(torch, kernels, parity, paths: dict, card: str,
                  dev) -> None:
    """Phase 8: raw-integer ingest into ``qa_deterministic`` (module doc)."""
    from mdx_torch.core import qa
    from mdx_torch.ops.ingest import normalize_ingest

    t8 = time.perf_counter()
    raw, scalars = _ingest_stack()
    on_dev = [torch.from_numpy(v).to(dev) for v in scalars]

    def program(raw_np, device, pfm, sc):
        x = normalize_ingest(torch.from_numpy(raw_np).to(device), *sc,
                             per_frame_minmax=pfm)
        return qa.qa_deterministic(x)

    for pfm in (True, False):
        mode = "frame_minmax" if pfm else "stack_bounds"
        res, paths[f"ingest_{INGEST_N}x512_{mode}"] = _run_path(
            torch, kernels, f"ingest + qa_deterministic [{INGEST_N},512,512] "
            f"{mode}", lambda: program(raw, dev, pfm, on_dev))
        _require_finite(f"ingest {mode}", parity.flatten_result(
            res, parity.QA_DETERMINISTIC_FIELDS), INGEST_N, 512)
        del res
        on_card = parity.flatten_result(
            program(raw[:2], dev, pfm, [v[:2] for v in on_dev]),
            parity.QA_DETERMINISTIC_FIELDS)
        on_cpu = parity.flatten_result(
            program(raw[:2], "cpu", pfm,
                    [torch.from_numpy(v[:2]) for v in scalars]),
            parity.QA_DETERMINISTIC_FIELDS)
        bad = parity.breaches(on_card, on_cpu)
        print(f"ingest {mode} [2,512,512] card vs cpu: {len(on_cpu)} fields, "
              f"enhanced max|d| {parity.max_abs(on_card, on_cpu, 'enhanced')!r}"
              f", breaches {len(bad)}")
        for line in bad:
            print("  " + line)
        _require(not bad, f"ingest {mode}: card and CPU disagree")
        med, times = _median_ms(
            torch, lambda: program(raw, dev, pfm, on_dev), REPS)
        print(f"ingest {mode} [{INGEST_N},512,512] uint16 upload + "
              f"normalize + qa_deterministic on {card}: median {med!r} ms "
              f"of {REPS} reps (min {min(times)!r}, max {max(times)!r}), "
              f"{INGEST_N / med * 1e3!r} img/s")
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")


def _spatial_args(torch, name: str, x, two_d: bool = False):
    """A recorded wrapper's arguments on a block ``x`` as the sharded path
    hands them over: the LUT stage at the check's clip limit and tile; the
    block's own LUTs with edge copies as the halo; kernel 12 on an interior
    block (the middle row block of three; ``two_d``: the middle tile of a
    3 x 3 grid, with column slabs) with s-wide slabs: a launch of s
    iterations with every image active, and the rebuild of an image whose
    last launch was odd with s - 1 iterations left."""
    from mdx_torch import kernels
    from mdx_torch.parallel import clahe_sp

    n, h, w = x.shape
    g = torch.Generator(device=x.device).manual_seed(5)
    if name == "clahe_luts":
        return (x, torch.full((n,), 0.02, device=x.device), 16)
    if name == "clahe_remap_ext":
        lut = clahe_sp.clahe_luts(x, 0.02, 16)
        lut = torch.cat([lut[:, :1], lut, lut[:, -1:]], dim=1)
        lut = torch.cat([lut[:, :, :1], lut, lut[:, :, -1:]], dim=2)
        return (x, lut.contiguous(), 16)
    s = kernels.tv_steps()

    def small(*shape):
        return 0.05 * torch.randn(*shape, device=x.device, generator=g)

    def slabs(planes, level):
        return (level + small(n, planes, s, w), level + small(n, planes, s, w),
                *((level + small(n, planes, h + 2 * s, s),) * 2 if two_d
                  else (None, None)))

    geo = (3 * h, 3 * w if two_d else w, h, w if two_d else 0, s)
    weight = torch.full((n,), 0.05, device=x.device)
    if name == "tv_shard_step":
        return (x, small(n, 2, h, w), torch.empty((n, 2, h, w),
                                                   device=x.device),
                torch.ones(n, dtype=torch.int32, device=x.device), weight,
                slabs(1, 0.5), slabs(2, 0.0), geo, s)
    base = torch.full((n,), s, dtype=torch.int32, device=x.device)
    return (x, small(n, 2, h, w), small(n, 2, h, w), base + s, base, weight,
            slabs(1, 0.5), slabs(2, 0.0), slabs(2, 0.0), geo, s)


def _tensor_bytes(torch, args) -> int:
    """Bytes of the tensors among ``args``, in tuples (slab sets) too."""
    return sum(a.numel() * a.element_size() if torch.is_tensor(a)
               else _tensor_bytes(torch, a) if isinstance(a, tuple) else 0
               for a in args)


def _spatial_bound(torch, name: str, args) -> tuple[float, str, float]:
    """(least ms, "bytes" or "operations", kernel 12's old bound) of one
    recorded wrapper's call: the LUT stage reads x and writes the LUT grid;
    kernel 11 reads x and the LUT grid and writes out; a launch of kernel 12
    reads x, p and the slabs and writes p and the sums, against 23
    operations a pixel and iteration (counted as kernel T's bound); its
    rebuild reads x, one dual buffer and the slabs and writes out, with
    its s - 1 iterations.  The old bound: a launch an iteration, 24 bytes a
    pixel and iteration (None for the others)."""
    n, h, w = args[0].shape
    px = n * h * w
    old = None
    if name == "clahe_luts":
        t = args[2]
        moved = 4 * px + 4 * 256 * n * -(-h // t) * -(-w // t)
        ops = px * OPS_PER_PIXEL[name]
    elif name == "clahe_remap_ext":
        moved = 8 * px + args[1].numel() * 4
        ops = px * OPS_PER_PIXEL[name]
    elif name == "tv_shard_step":
        m = args[-1]
        moved = _tensor_bytes(torch, args) + 16 * n * m
        ops = px * m * OPS_PER_PIXEL[name]
        old = 24 * px * m / HBM_BYTES_PER_S * 1e3
    else:         # the rebuild: x, p_odd and their slabs in, out written
        r = int((args[3] - 1 - args[4]).max())
        moved = _tensor_bytes(torch, args[:1] + args[2:3] + args[6:7]
                              + args[8:9]) + 4 * px
        ops = px * r * OPS_PER_PIXEL["tv_shard_step"]
        old = 24 * px * r / HBM_BYTES_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", old)


# the device functions of the recorded wrappers (csrc/clahe.cu, csrc/tv.cu)
DEVICE_FUNCTIONS = {"clahe_luts": ("clahe_lut_kernel",),
                    "clahe_remap_ext": ("clahe_remap_ext_kernel",),
                    "tv_shard_step": ("tv_blk_step_kernel",
                                      "tv_blk_rank_sums_kernel"),
                    "tv_shard_rebuild": ("tv_blk_rebuild_kernel",)}


def _time_spatial_kernels(torch, kernels, check, x, card: str,
                          two_d: bool = False) -> dict:
    """Kernels 11 and 12 and CLAHE's LUT stage against their plain versions
    on the block ``x`` (plain, kernel, kernel, plain; CUDA events), outputs
    compared (the LUT stage's error goes to the CLAHE row); and the
    kernels' device time from a profiler trace.  ``two_d``: kernel 12 with
    halo columns, as an interior tile of a 2-D grid runs it."""
    from mdx_torch.tools import spatial_check as SC
    from mdx_torch.tools import device_ms

    label = "x".join(map(str, x.shape)) + (" tile" if two_d else "")
    out = {}
    for k in SC.RECORDED:
        args = _spatial_args(torch, k, x, two_d)
        err, ok = SC.compare_call(k, args)
        row = SC.ROW_OF.get(k, k)
        check.errs[row] = max(check.errs[row], err)
        print(f"kernel parity [{label}] {k}: max|d| {err!r} "
              f"(tol {parity_tol(row)})")
        if not ok:
            check.failed.append(f"[{label}] {k}: max|d| {err!r}")
        kern = lambda k=k, a=args: getattr(kernels, k)(*a)  # noqa: E731
        plain = lambda k=k, a=args: SC.plain_of(k)(*a)  # noqa: E731
        p1 = _sync_ms(torch, plain, 20)
        k1 = _sync_ms(torch, kern, 20)
        k2 = _sync_ms(torch, kern, 20)
        p2 = _sync_ms(torch, plain, 20)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound_ms, bound_by, old = _spatial_bound(torch, k, args)
        dev_ms = device_ms(kern, 20, DEVICE_FUNCTIONS[k])
        print(f"time [{label}] {k} on {card}: kernel {ms!r} ms "
              f"({k1!r}, {k2!r}; device {dev_ms!r} ms), plain {plain_ms!r} "
              f"ms ({p1!r}, {p2!r}), bound {bound_ms!r} ms ({bound_by})"
              + ("" if old is None else f", a launch an iteration's bound "
                 f"{old!r} ms"))
        out[k] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
        if old is not None:
            out[k].update(iterations=(args[-1] if k == "tv_shard_step" else
                                      int((args[3] - 1 - args[4]).max())),
                          bound_per_step_ms=old)
    check.require_ok()
    return out


def parity_tol(name: str) -> str:
    from mdx_torch import parity

    rtol, atol = parity.KERNEL_TOL[name]
    return f"{atol} + {rtol}*|plain|"


def _gathered(results, key: str, n_space):
    """One frame's ``key`` from the ranks' results: row blocks or tiles put
    back in place (n_data = 1)."""
    from mdx_torch.parallel import launch

    return launch.assemble([{key: r[key]} for r in results], 1, n_space,
                           block_keys=(key,))[key]


def on_grid(*blocks, fn, grid_2d, mesh, **kwargs):
    """A rank function for a launch whose ranks also serve a second layout:
    ``fn`` on the (sy, sx) = ``grid_2d`` tile mesh of the same ranks (one
    data row, so the launch's process group serves it and no group is
    made), its blocks the tiles stacked by :func:`_tiles_as_rows`."""
    from mdx_torch.parallel.mesh import make_mesh2d

    tiles = make_mesh2d(mesh.rank, 1, *grid_2d, mesh.device, mesh.backend)
    return fn(*blocks, mesh=tiles, **kwargs)


def _tiles_as_rows(a, sy: int, sx: int):
    """[N, H, W] → its (sy, sx) tiles stacked along the rows in rank order,
    so that a launch of sy·sx row blocks hands rank r the tile r."""
    import numpy as np

    hs, ws = a.shape[1] // sy, a.shape[2] // sx
    return np.ascontiguousarray(np.concatenate(
        [a[:, r * hs:(r + 1) * hs, c * ws:(c + 1) * ws]
         for r in range(sy) for c in range(sx)], axis=1))


def _spatial_runs(torch, kernels, parity, check, paths: dict, card: str, x,
                  layouts: tuple, want, schedule: bool = False) -> dict:
    """One launch that runs ``spatial_check.rank_check`` on each of
    ``layouts`` (row blocks or a (sy, sx) grid, all of one rank count: the
    first is the launch's own, a later one runs on the same ranks through
    :func:`on_grid` on tile-stacked inputs), each with its checks
    (:func:`_check_spatial_run`); with ``schedule``, kernel 12's schedule
    cases on each layout (:func:`_tv_schedule_calls`) after its
    ``rank_check`` in the same launch, checked after it → {layout:
    (flattened plan result, qa_spatial's frame, rank 0's result)}."""
    import dataclasses

    from mdx_torch.parallel import launch
    from mdx_torch.parallel.launch import Block
    from mdx_torch.parallel.mesh import grid
    from mdx_torch.tools import spatial_check as SC

    static_cpu, dyn_cpu = _bench_plan("cpu")
    inputs, calls, parts = [], [], []
    for i, n_space in enumerate(layouts):
        part = {"n_space": n_space, "first": len(calls), "cases": None}
        inputs.append(_tiles_as_rows(x, *grid(n_space)) if i else x)
        call = (SC.rank_check, (Block(len(inputs) - 1), static_cpu, dyn_cpu),
                {})
        calls.append(call if not i else (on_grid, call[1], {
            "fn": SC.rank_check, "grid_2d": grid(n_space)}))
        if schedule:
            part["cases"] = _tv_schedule_calls(kernels, x, n_space,
                                               first=len(inputs),
                                               as_rows=i > 0)
            inputs += part["cases"]["inputs"]
            calls += part["cases"]["calls"]
        part["end"] = len(calls)
        parts.append(part)
    t0 = time.perf_counter()
    res = launch.run(launch.call_each, tuple(inputs), n_space=layouts[0],
                     device="cuda", timeout_s=900, calls=calls)
    wall = time.perf_counter() - t0
    out = {}
    for part in parts:
        per_rank = [r[part["first"]:part["end"]] for r in res.results]
        view = dataclasses.replace(res, results=[r[0] for r in per_rank],
                                   n_space=part["n_space"])
        out[part["n_space"]], label = _check_spatial_run(
            kernels, parity, check, paths, card, view, want, wall,
            len(layouts))
        if schedule:
            _tv_schedule_check(parity, [r[1:] for r in per_rank],
                               part["cases"], f"{label} (in the launch)")
    return out


def _check_spatial_run(kernels, parity, check, paths: dict, card: str, res,
                       want, wall: float, shared: int) -> tuple:
    """``rank_check``'s results on one layout (``res``: the launch with
    those results and that layout): kernels 11 and 12 launched on every
    rank, finite outputs, rank 0's recorded calls replayed, the whole TV
    solve kernels vs plain on every rank, the frame against the dense
    ``qa_plan`` (``want``); prints the ms per call → ((flattened plan
    result, qa_spatial's frame, rank 0's result), the layout's label)."""
    import numpy as np

    from mdx_torch.tools import spatial_check as SC

    rs = res.results
    two_d = isinstance(res.n_space, tuple)
    tag = "x".join(map(str, res.n_space)) if two_d else f"k{res.n_space}"
    label = (f"{'layout ' + tag if two_d else 'k=' + str(res.n_space)} "
             f"{res.backend} on {sorted(set(res.devices))}")
    print(f"spatial {label}: launch {wall:.1f} s"
          + (f" (one launch for {shared} layouts)" if shared > 1 else ""))
    for path in ("plan", "qa"):
        per_rank = [r[f"launches_{path}"] for r in rs]
        print(f"launches in qa_{path}_spatial {label}, per rank: "
              f"{per_rank}")
        for kname in SPATIAL_KERNELS + ("clahe",):
            _require(all(int(lr[kname]) > 0 for lr in per_rank),
                     f"{kname} not launched on every rank of "
                     f"qa_{path}_spatial {label}")
        paths[f"spatial_{path}_{tag}"] = {
            kname: sum(int(lr[kname]) for lr in per_rank)
            for kname in kernels.LAUNCHES}
    r0 = rs[0]
    print(f"rank 0 stages {label} (s): "
          f"{ {k: round(float(v), 2) for k, v in r0['stage_s'].items()} }")
    got = {"enhanced": _gathered(rs, "enhanced", res.n_space),
           "flags": r0["flags"], "validation": r0["validation"],
           "score": r0["score"]}
    flat = parity.flatten(got)
    _require_finite(f"qa_plan_spatial {label}", flat, 1, SPATIAL_SIZE)
    qa_enh = _gathered(rs, "qa_enhanced", res.n_space)
    _require(bool(np.isfinite(qa_enh).all()),
             f"qa_spatial {label}: non-finite output")
    for name, (n_calls, err, ok) in r0["replay"].items():
        row = SC.ROW_OF.get(name, name)
        print(f"replayed rank 0 {label} {name}: {int(n_calls)} calls, "
              f"max|d| {float(err)!r} (tol {parity_tol(row)})")
        check.errs[row] = max(check.errs[row], float(err))
        _require(bool(ok) and int(n_calls) > 0,
                 f"{name} replay {label}: max|d| {float(err)!r}")
    for rank, r in enumerate(rs):
        tv = r["tv_solve"]
        it_k, it_p = tv["iters_kernel"].tolist(), tv["iters_plain"].tolist()
        print(f"tv solve rank {rank} {label}: "
              f"kernel vs plain max|d| {tv['max_abs_err']!r}, iterations "
              f"kernel {it_k} plain {it_p}")
        _require(it_k == it_p, f"tv solve {label}: iteration counts")
        _require(tv["max_abs_err"] <= parity.KERNEL_TOL[
            "tv_shard_step"][1], f"tv solve {label}: kernel vs plain")
        sched = tv["schedule"]
        steps, n_launch = int(sched["steps"]), int(sched["launches"])
        print(f"tv solve rank {rank} {label}: {steps} iterations a launch, "
              f"{n_launch} step launches + 1 rebuild for {max(it_k)} "
              f"iterations, {int(sched['host_reads'])} flag reads, "
              f"{int(sched['round_trips'])} host round trips a solve")
        _require(n_launch <= -(-max(it_k) // steps) + 1,
                 f"tv solve {label}: {n_launch} step launches")
    r0["tv_solve_summary"] = _solve_summary(res, r0["tv_timing"])
    print(f"tv solve times rank 0 {label} on {card}: "
          f"{json.dumps(r0['tv_solve_summary'])}")
    bad = parity.breaches(flat, want, tv_ran=True)
    print(f"qa_plan_spatial {label} vs dense qa_plan on the card: "
          f"enhanced max|d| {parity.max_abs(flat, want, 'enhanced')!r}, "
          f"score {flat['score'].tolist()} vs {want['score'].tolist()}, "
          f"breaches {len(bad)}")
    for line in bad:
        print("  " + line)
    _require(not bad, f"qa_plan_spatial {label} and dense qa_plan differ")
    med = statistics.median(r0["plan_ms"])
    print(f"qa_plan_spatial [1,{SPATIAL_SIZE},{SPATIAL_SIZE}] {label} on "
          f"{card}: median {med!r} ms of {len(r0['plan_ms'])} reps "
          f"({[float(v) for v in r0['plan_ms']]}), "
          f"{int(r0['plan_round_trips'])} host round trips per call"
          + (" (several ranks on one card over gloo: host staging, not "
             "scaling)" if len(rs) > 1 else ""))
    return (flat, qa_enh, r0), label


def _solve_summary(res, timing) -> dict:
    """Rank 0's sharded TV solve times (``time_tv_shard.summary``)."""
    from mdx_torch.tools import time_tv_shard

    layout = ("x".join(map(str, res.n_space))
              if isinstance(res.n_space, tuple) else str(res.n_space))
    return time_tv_shard.summary(timing, layout, res.backend)


# kernel 12's schedule cases: weights of three copies of one frame that stop
# in three different launches of both parities (the dense plain version on
# the CPU counts 12, 30 and 40 iterations on the clipped 2048^2 frame:
# launches 2, 7 and 9 at s = 4)
MIX_W = (0.01, 0.03, 0.5)
# the cap cases' crop: its first TV_CAP_ROWS rows at k = 4 (128 a rank, the
# frame's width), its TV_CAP_ROWS x TV_CAP_ROWS corner on the 2 x 2 grid
# (256 x 256 tiles).  With eps = 0 a cap's stop offset within a launch does
# not depend on the extent; the 18 cap solves are the cases' bulk, and the
# crop gives them a quarter (k = 4) or a sixteenth (2 x 2) of the frame's
# pixels to stage through host memory over gloo.
TV_CAP_ROWS = 512


def _tv_schedule_calls(kernels, x, n_space, first: int,
                       as_rows: bool = False) -> dict:
    """Kernel 12 against the plain sharded solve on ``n_space`` (gloo,
    every call on every rank), as ``launch.call_each`` calls on inputs
    ``first``, ``first`` + 1 and ``first`` + 2 of a launch: caps 1 .. 2s + 1
    with eps = 0 on a crop of the frame (``TV_CAP_ROWS``: a stop at every
    offset of a launch, short last launches), three copies of the whole
    frame with ``MIX_W`` (images stopping in different launches), and an
    [2, 8, 6] corner of it (blocks and tiles thinner than s: 2 or 3
    iterations a launch); ``as_rows``: the inputs tile-stacked and the calls
    through :func:`on_grid`, for a launch of row blocks that serves the
    grid ``n_space`` → {"inputs", "calls", "caps", "crop", "s"}."""
    import numpy as np
    import torch

    from mdx_torch.parallel import tv_sp
    from mdx_torch.parallel.launch import Block
    from mdx_torch.parallel.mesh import grid

    s = kernels.tv_steps()
    y = np.clip(x, 0.0, 1.0)
    crop = np.ascontiguousarray(
        y[:, :TV_CAP_ROWS, :TV_CAP_ROWS if grid(n_space)[1] > 1 else None])
    inputs = (crop, np.repeat(y, 3, axis=0),
              np.repeat(y[:, :8, :6], 2, axis=0).copy())
    caps = range(1, 2 * s + 2)
    cases = [((Block(first), 0.05), dict(eps=0.0, max_iter=c)) for c in caps]
    cases += [((Block(first + 1), torch.tensor(MIX_W)), {}),
              ((Block(first + 2), 0.05), {})]
    calls = [c for args, kw in cases for c in (
        (tv_sp.tv_sharded, args, kw), (tv_sp.tv_sharded_plain, args, kw))]
    if as_rows:
        inputs = tuple(_tiles_as_rows(a, *grid(n_space)) for a in inputs)
        calls = [(on_grid, args, dict(kw, fn=fn, grid_2d=grid(n_space)))
                 for fn, args, kw in calls]
    return {"inputs": inputs, "calls": calls, "caps": caps,
            "crop": crop.shape, "s": s}


def _tv_schedule_check(parity, per_rank: list, sched: dict,
                       label: str) -> None:
    """The results of :func:`_tv_schedule_calls`'s calls on every rank
    (``per_rank``): pixels within ``KERNEL_TOL`` (and printed: the design
    is exact), counts equal, every cap reached, the mixed case stopping in
    more than one launch."""
    import numpy as np

    s, caps, crop = sched["s"], sched["caps"], sched["crop"]
    err = 0.0
    for r in per_rank:
        for i in range(0, len(r), 2):
            (got, it_k), (want, it_p) = r[i], r[i + 1]
            _require(it_k.tolist() == it_p.tolist(),
                     f"tv schedule {label} case {i // 2}: counts "
                     f"{it_k.tolist()} vs {it_p.tolist()}")
            err = max(err, float(np.abs(got - want).max()))
        for i, cap in enumerate(caps):
            _require(r[2 * i][1].tolist() == [cap],
                     f"tv schedule {label}: cap {cap}")
    mix = per_rank[0][-4][1].tolist()
    print(f"tv schedule cases {label}: caps 1..{2 * s + 1} on "
          f"[1,{crop[1]},{crop[2]}], mixed stops {mix} (launches "
          f"{[(c - 1) // s for c in mix]}), thin blocks "
          f"{per_rank[0][-2][1].tolist()}: kernel vs plain max|d| {err!r}, "
          f"counts equal")
    _require(len({(c - 1) // s for c in mix}) > 1,
             f"tv schedule {label}: the mixed case stops in one launch")
    _require(err <= parity.KERNEL_TOL["tv_shard_step"][1],
             f"tv schedule {label}: kernel vs plain max|d| {err!r}")


def _against(label: str, parity, a: tuple, b: tuple) -> None:
    """Two sharded runs of the same frame (``_spatial_runs``'s results):
    the plan and qa frames within ``parity.breaches``, flags equal."""
    import numpy as np

    (fa, qa_a, ra), (fb, qa_b, rb) = a, b
    bad = parity.breaches(fa, fb, tv_ran=True)
    bad += [f"qa_spatial enhanced: {line}" for line in parity.breaches(
        {"enhanced": qa_a}, {"enhanced": qa_b}, tv_ran=True)]
    for key in ("qa_passes", "qa_noise_amp"):
        if not np.array_equal(ra[key], rb[key]):
            bad.append(f"{key}: {ra[key].tolist()} vs {rb[key].tolist()}")
    print(f"{label}: plan enhanced max|d| "
          f"{parity.max_abs(fa, fb, 'enhanced')!r} (bit-equal "
          f"{bool(np.array_equal(fa['enhanced'], fb['enhanced']))}), qa "
          f"enhanced max|d| {float(np.abs(qa_a - qa_b).max())!r}, breaches "
          f"{len(bad)}")
    for line in bad:
        print("  " + line)
    _require(not bad, f"{label} differ")


def _phase_spatial(torch, kernels, parity, check, paths: dict, card: str,
                   dev) -> tuple[dict, dict]:
    """Phase 9: the row-sharded path on one 2048^2 frame (module doc) →
    (kernel times by shape, the runs by k)."""
    from mdx_torch.core import qa
    from mdx_torch.tools import make_batch

    t9 = time.perf_counter()
    torch.cuda.empty_cache()
    x = make_batch(1, SPATIAL_SIZE, seed=4)
    want = parity.flatten_result(
        qa.qa_plan(torch.from_numpy(x).to(dev), *_bench_plan(dev)),
        parity.QA_PLAN_FIELDS)
    runs = _spatial_runs(torch, kernels, parity, check, paths, card, x, (1,),
                         want)
    # k = 4 row blocks and phase 10's (2, 2) tiles share one launch
    runs.update(_spatial_runs(torch, kernels, parity, check, paths, card, x,
                              (SPATIAL_K, SPATIAL_2D), want, schedule=True))
    _against(f"k={SPATIAL_K} vs k=1", parity, runs[SPATIAL_K], runs[1])

    xd = torch.from_numpy(x).to(dev)
    hs = SPATIAL_SIZE // SPATIAL_K
    shard, whole = f"1x{hs}x{SPATIAL_SIZE}", f"1x{SPATIAL_SIZE}x{SPATIAL_SIZE}"
    times = {shard: _time_spatial_kernels(
                 torch, kernels, check, xd[:, :hs].contiguous(), card),
             whole: _time_spatial_kernels(torch, kernels, check, xd, card)}
    times[shard]["tv_shard_solve"] = runs[SPATIAL_K][2]["tv_solve_summary"]
    times[whole]["tv_shard_solve"] = runs[1][2]["tv_solve_summary"]
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    return times, runs


def _phase_tiles(torch, kernels, parity, check, paths: dict, card: str,
                 dev, runs: dict) -> dict:
    """Phase 10: the 2-D tile layout on the same frame (module doc; its
    ranks ran in phase 9's k = 4 launch, ``runs[SPATIAL_2D]``) → the
    kernel times at the tile."""
    from mdx_torch.tools import make_batch

    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    x = make_batch(1, SPATIAL_SIZE, seed=4)
    tiles = runs[SPATIAL_2D]
    sy, sx = SPATIAL_2D
    _against(f"layout {sy}x{sx} vs k={SPATIAL_K} row blocks", parity, tiles,
             runs[SPATIAL_K])
    hs, ws = SPATIAL_SIZE // sy, SPATIAL_SIZE // sx
    xt = torch.from_numpy(x[:, :hs, :ws].copy()).to(dev)
    tile = f"1x{hs}x{ws} tile"
    times = {tile: _time_spatial_kernels(torch, kernels, check, xt, card,
                                         two_d=True)}
    times[tile]["tv_shard_solve"] = tiles[2]["tv_solve_summary"]
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    return times


def _phase_probe(torch, card: str) -> dict:
    """Phase 11: kernel 13, the capability probe (module doc) → its row of
    the kernels line."""
    from mdx_torch.tools import probe_nvcc as PN
    from mdx_torch.tools import device_ms

    t11 = time.perf_counter()
    t0 = time.perf_counter()
    built = PN.build()
    print(f"probe build: {len(built)} probes, one nvcc each, all started "
          f"together: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    for k in PN.LAUNCHES:
        PN.LAUNCHES[k] = 0
    res = PN.run_suite()
    torch.cuda.synchronize()
    launches = dict(PN.LAUNCHES)
    print(f"launches in the probe suite: {launches}")
    by_probe = {}
    for name, r in res.items():
        print(f"probe {name:38s} {r['result']}  (registers "
              f"{r['registers']}, spill {r['spill_stores']}/"
              f"{r['spill_loads']} B; max|d| vs plain "
              f"{r.get('max_abs_err')!r}, one PyTorch call equal "
              f"{r.get('library_equal')})")
    bad = [n for n, r in res.items() if r["result"] != "ok"
           or not r["library_equal"] or launches[n] < 1]
    _require(not bad, f"probes not ok: {bad}")
    dev = torch.device("cuda", 0)
    # the select matmul keeps one term of each sum, of integer values: it is
    # exact, though the TPU tool checks it with allclose
    sel = "iota_select_matmul_deinterleave"
    x = PN.probe_input(sel, dev)
    _require(torch.equal(PN.launch(sel, built[sel], x),
                         PN.plain_output(sel, x)), f"{sel}: not bit-equal")
    for name in res:
        x = PN.probe_input(name, dev)
        t = PN.time_probe(name, built[name], x)
        # every probe's kernel is `k`; the CUDA-event time of a launch also
        # holds the ctypes wrapper's host work
        t["device_ms"] = device_ms(
            lambda name=name, x=x: PN.launch(name, built[name], x), 20,
            ("k(float const*, float*)",))
        # the PyTorch call's device time: every device operation of the call
        # in the trace (its kernels' names vary with the call)
        t["library_device_ms"] = device_ms(
            lambda name=name, x=x: PN.LIBRARY[name](x), 20)
        print(f"time probe {name} on {card}: kernel {t['ms']!r} ms a launch "
              f"(device {t['device_ms']!r}), plain {t['plain_ms']!r}, one "
              f"PyTorch call {t['library_ms']!r} (device "
              f"{t['library_device_ms']!r}), bound {t['bound_ms']!r} ms "
              f"({t['bound_by']})")
        by_probe[name] = dict(t, launches=launches[name],
                              registers=res[name]["registers"],
                              max_abs_err=res[name]["max_abs_err"])
    def total(key):
        """The sum over the probes; None if the trace missed any of them."""
        vals = [t[key] for t in by_probe.values()]
        return None if None in vals else sum(vals)

    by_ops = sum(t["bound_ms"] for t in by_probe.values()
                 if t["bound_by"] == "operations")
    unmeasured = [n for n, t in by_probe.items()
                  if t["device_ms"] is None or t["library_device_ms"] is None]
    slower = [n for n, t in by_probe.items() if n not in unmeasured
              and t["device_ms"] > t["library_device_ms"]]
    t = by_probe[sel]
    print(f"{sel}: device {t['device_ms']!r} ms against its PyTorch call's "
          f"{t['library_device_ms']!r} ms")
    print(f"probes slower than their PyTorch call on the device: {slower} "
          f"(device {total('device_ms')!r} ms against "
          f"{total('library_device_ms')!r} ms over the 18; no device time in "
          f"the trace for {unmeasured})")
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")
    return {
        "name": "capability_probe", "route": "cuda",
        "source": SOURCE["capability_probe"],
        "replaces": REPLACES["capability_probe"],
        "launches": sum(launches.values()),
        "launches_by_path": {"probe_suite": sum(launches.values())},
        "max_abs_err": max(t["max_abs_err"] for t in by_probe.values()),
        "shape": "18 probes on [8,128], [16,256] and [256,512] aranges",
        "ms": total("ms"), "device_ms": total("device_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops * 2 > total("bound_ms")
        else "bytes",
        "library_ms": total("library_ms"),
        "library_device_ms": total("library_device_ms"),
        "by_probe": by_probe}


# phase 12: the CLI on its config-1 and config-5 inputs
CLI_SIZE, CLI_SERIES_N = 512, 64
CLI_KINDS = ("noisy", "low_contrast", "clipped", "blurred")
MIXED_CT, MIXED_CXR, MIXED_US = 8, 4, 8
US_SHAPE = (480, 640)


def _blurred_phantom(size: int):
    """The 12-bit phantom slice (``write_synthetic_dicom(kind="phantom")``'s
    first frame) under a separable Gaussian of sigma 3 px, stored uint16:
    a slice that the issue-driven chain sharpens (blur: kernel U)."""
    import numpy as np

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)
    r = np.hypot(yy - 0.5, xx - 0.5)
    img = (r < 0.4) * (0.6 + 0.3 * np.cos(8 * np.pi * r))
    img = np.clip(img + rng.normal(0, 0.02, (size, size)), 0, 1) * 4095
    t = np.arange(-12, 13)
    g = np.exp(-t * t / 18.0)
    g /= g.sum()
    p = np.pad(img, 12, mode="reflect")
    p = np.stack([np.convolve(row, g, mode="valid") for row in p])
    p = np.stack([np.convolve(col, g, mode="valid") for col in p.T]).T
    return np.rint(p).astype(np.uint16)


def _mixed_ct_cxr(d: str, also_ct=()) -> None:
    """Config 5's CT slices (VOI windows) and chest X-rays, written into
    ``d``; the CT slices also into each directory of ``also_ct``."""
    import numpy as np

    from mdx_torch.io import write_dicom, write_synthetic_dicom
    from mdx_torch.tools import make_batch

    for i in range(MIXED_CT):
        for dd in (d, *also_ct):
            write_synthetic_dicom(f"{dd}/ct{i}.dcm", kind="phantom",
                                  size=CLI_SIZE, seed=30 + i,
                                  window_center=1024.0 + 16 * i,
                                  window_width=2048.0)
    for i in range(MIXED_CXR):
        pix = np.rint(make_batch(1, BIG, seed=40 + i)[0] * 65535)
        write_dicom(f"{d}/cxr{i}.dcm", pix.astype(np.uint16),
                    modality="DX", body_part="CHEST")


def _cli_singles(root) -> dict:
    """Phase 12's four 512^2 16-bit CT slices (``CLI_KINDS``), written with
    the port's writer under ``root``: kind → path."""
    from mdx_torch.io import write_dicom, write_synthetic_dicom

    f = {}
    for i, kind in enumerate(CLI_KINDS[:3]):
        f[kind] = write_synthetic_dicom(f"{root}/{kind}.dcm", kind=kind,
                                        size=CLI_SIZE, seed=20 + i)
    f["blurred"] = write_dicom(f"{root}/blurred.dcm",
                               _blurred_phantom(CLI_SIZE),
                               rescale_slope=1.0, rescale_intercept=-1024.0)
    return f


def _write_cxr(root) -> str:
    """Phase 12's 2048^2 16-bit chest X-ray, written under ``root``."""
    import numpy as np

    from mdx_torch.io import write_dicom
    from mdx_torch.tools import make_batch

    cxr = np.rint(make_batch(1, BIG, seed=8)[0] * 65535).astype(np.uint16)
    return write_dicom(f"{root}/cxr.dcm", cxr, modality="DX",
                       body_part="CHEST", study_description="CXR PA")


def _cli_inputs(root) -> dict:
    """Phase 12's files, written with the port's writer under ``root``."""
    import os

    import numpy as np

    from mdx_torch.io import write_dicom, write_synthetic_dicom
    from mdx_torch.io.dicom import TS_RLE

    f = _cli_singles(root)
    f["cxr"] = _write_cxr(root)
    f["series"] = write_synthetic_dicom(f"{root}/series.dcm", kind="phantom",
                                        size=CLI_SIZE, frames=CLI_SERIES_N,
                                        seed=3)
    f["series_rle"] = write_synthetic_dicom(
        f"{root}/series_rle.dcm", kind="phantom", size=CLI_SIZE,
        frames=CLI_SERIES_N, seed=3, transfer_syntax=TS_RLE)
    mixed, ct_only = f"{root}/mixed", f"{root}/ct_only"
    os.makedirs(mixed)
    os.makedirs(ct_only)
    rng = np.random.default_rng(9)
    _mixed_ct_cxr(mixed, also_ct=(ct_only,))
    yy, xx = np.mgrid[0:US_SHAPE[0], 0:US_SHAPE[1]]
    for i in range(MIXED_US):
        speckle = rng.gamma(4.0, 0.25, US_SHAPE)
        img = (0.5 + 0.3 * np.sin(xx / (20.0 + i)) * np.cos(yy / 33.0)) * speckle
        write_dicom(f"{mixed}/us{i}.dcm",
                    np.clip(img * 160, 0, 255).astype(np.uint8),
                    modality="US", body_part="ABDOMEN",
                    photometric="MONOCHROME1" if i < 2 else "MONOCHROME2")
    f["mixed"], f["ct_only"] = mixed, ct_only
    return f


def _cli_main(cli, argv, dev) -> tuple[int, str]:
    """``python -m mdx_torch``'s main on ``dev``, its printed output kept."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=dev)
    return rc, buf.getvalue()


def _check_cli_run(path: str, out: str, rc: int, text: str) -> dict:
    """A single-image CLI run: rc 0, the report printed and on disk, a PNG
    that decodes at the panel's shape, and its DB row read back."""
    import os

    from mdx_torch.io.visuals import read_png
    from mdx_torch.pipeline import storage

    base = os.path.splitext(os.path.basename(path))[0]
    _require(rc == 0, f"cli {base}: rc {rc}: {text[-500:]}")
    report = open(f"{out}/{base}_report.md", encoding="utf-8").read()
    _require(text.strip() == report.strip() and report.startswith("# "),
             f"cli {base}: printed report differs from {base}_report.md")
    png = read_png(f"{out}/{base}_before_after.png")
    runs = [r for r in storage.list_runs(limit=1000)
            if r["input_filename"] == os.path.basename(path)]
    _require(bool(runs), f"cli {base}: no DB row")
    row = storage.get_run(runs[0]["run_id"])
    _require(row is not None and row["status"] in ("PASS", "WARN", "FAIL")
             and "**Status:** " in report and row["status"] in report,
             f"cli {base}: DB row {row and row['status']}")
    return {"png": png.shape, "status": row["status"],
            "issues": row["issues"]}


def _phase_cli(torch, kernels, parity, check, paths: dict, card: str,
               dev) -> None:
    """Phase 12: the port's CLI on config-1 and config-5 inputs (module
    doc), its files and DB in a temporary directory."""
    import os
    import tempfile

    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
        os.environ.pop("MDX_TV_MODE", None)
        _cli_checks_and_times(torch, kernels, parity, check, paths, card,
                              dev, tmp, t12)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")


def _cli_checks_and_times(torch, kernels, parity, check, paths, card, dev,
                          tmp, t12) -> None:
    import os

    import numpy as np

    from mdx_torch import __main__ as cli
    from mdx_torch.pipeline import batch_runner as PB
    from mdx_torch.pipeline.runner import run_pipeline
    from mdx_torch.tools import cli_latency as CL

    f = _cli_inputs(tmp)
    out = f"{tmp}/out"
    print(f"cli inputs written: {time.perf_counter() - t12:.1f} s")

    # 12.1 single-image runs, deterministic (512^2 calls recorded) and
    # autotune, counters reset before each path
    singles = [f[k] for k in CLI_KINDS]
    calls: list = []
    with _recording(torch, kernels, calls):
        runs_512, paths["cli_512"] = _run_path(
            torch, kernels, f"cli [1,{CLI_SIZE},{CLI_SIZE}] x "
            f"{len(singles)} deterministic",
            lambda: [_cli_main(cli, ["--input", p, "--output", out,
                                     "--no-show"], dev) for p in singles])
    run_big, paths["cli_2048"] = _run_path(
        torch, kernels, f"cli [1,{BIG},{BIG}] deterministic",
        lambda: _cli_main(cli, ["--input", f["cxr"], "--output", out,
                                "--no-show"], dev))
    for p, (rc, text) in zip(singles + [f["cxr"]], runs_512 + [run_big]):
        got = _check_cli_run(p, out, rc, text)
        print(f"cli {os.path.basename(p)}: rc 0, {got}")
    auto_out = f"{tmp}/out_autotune"
    runs_auto, paths["cli_autotune"] = _run_path(
        torch, kernels, f"cli --autotune on {len(singles) + 1} files",
        lambda: [_cli_main(cli, ["--input", p, "--output", auto_out,
                                 "--autotune", "--no-show"], dev)
                 for p in singles + [f["cxr"]]])
    for p, (rc, text) in zip(singles + [f["cxr"]], runs_auto):
        got = _check_cli_run(p, auto_out, rc, text)
        _require("GenAI Plan (JSON)" in text, f"autotune {p}: no plan")
        print(f"cli --autotune {os.path.basename(p)}: rc 0, {got}")
    for k in ("box_stats", "unsharp", "clahe", "wavelet_denoise", "select"):
        n = sum(paths[q][k] for q in ("cli_512", "cli_2048", "cli_autotune"))
        _require(n > 0, f"kernel {k} was not launched by the CLI runs")
    check.replay(f"cli {CLI_SIZE}^2 deterministic", calls)
    del calls
    check.require_ok()

    # card against CPU: every file deterministic, the 512^2 files autotune
    # (a 27-lane sweep at 2048^2 on the CPU takes minutes)
    t0 = time.perf_counter()
    failed, reported = [], 0
    cases = [(p, False) for p in singles + [f["cxr"]]]
    cases += [(p, True) for p in singles]
    for p, auto in cases:
        got = run_pipeline(p, out, device=dev, autotune=auto,
                           save_artifacts=False)
        want = run_pipeline(p, out, device="cpu", autotune=auto,
                            save_artifacts=False)
        bad, soft = parity.compare_runs(got, want)
        label = f"{os.path.basename(p)}{' --autotune' if auto else ''}"
        err = float(np.abs(got["enhanced_image"].astype(np.float64)
                           - want["enhanced_image"]).max())
        print(f"cli card vs cpu {label}: issues {got['issues']} / "
              f"{want['issues']}, status {got['validation'].status} / "
              f"{want['validation'].status}, enhanced max|d| {err!r}, "
              f"breaches {len(bad)}, reported {len(soft)}")
        for line in bad:
            print("  breach: " + line)
        for line in soft:
            print("  reported (not determined on this input): " + line)
        reported += len(soft)
        if bad:
            failed.append(label)
    print(f"cli card vs cpu: {len(cases)} runs, {reported} reported lines "
          f"({time.perf_counter() - t0:.1f} s)")
    _require(not failed, f"cli: card and CPU disagree on {failed}")

    # 12.2 batch runs
    rc, text = _cli_main(cli, ["--input", f["series"], "--output", out,
                               "--batch", "--no-show"], dev)
    _require(rc == 0 and f"Frames processed: **{CLI_SERIES_N}**" in text,
             f"cli --batch series: rc {rc}: {text[:300]}")
    batch = lambda path, **kw: PB.run_pipeline_batch(  # noqa: E731
        path, out, device=dev, **kw)
    res_series, paths["batch_series"] = _run_path(
        torch, kernels, f"batch series [{CLI_SERIES_N},{CLI_SIZE},"
        f"{CLI_SIZE}] explicit LE, RLE, --window, --autotune",
        lambda: [batch(f["series"]), batch(f["series_rle"]),
                 batch(f["series"], window=True),
                 batch(f["series"], autotune=True)])
    res_mixed, paths["batch_mixed"] = _run_path(
        torch, kernels, f"batch mixed directory ({MIXED_CT} CT, "
        f"{MIXED_CXR} CXR, {MIXED_US} US), --window, --autotune",
        lambda: [batch(f["mixed"]), batch(f["mixed"], window=True),
                 batch(f["mixed"], autotune=True)])
    n_mixed = MIXED_CT + MIXED_CXR + MIXED_US
    for label, res, n in (("series", res_series, CLI_SERIES_N),
                          ("mixed", res_mixed, n_mixed)):
        for i, ctx in enumerate(res):
            frames = ctx["frames"]
            _require(len(frames) == n, f"batch {label} run {i}: "
                     f"{len(frames)} frames, not {n}")
            flat = parity.flatten_batch(frames)
            for k, v in flat.items():
                _require(v.dtype == bool or k.endswith("psnr")
                         or bool(np.isfinite(v).all()),
                         f"batch {label} run {i}: non-finite {k}")
        for k in ("box_stats", "wavelet_denoise", "select"):
            _require(paths[f"batch_{label}"][k] > 0,
                     f"kernel {k} was not launched by batch {label}")
    shapes = sorted({tuple(fr["shape"]) for fr in res_mixed[0]["frames"]})
    print(f"batch: series {CLI_SERIES_N} frames x 4 runs, mixed {n_mixed} "
          f"frames x 3 runs in buckets {shapes}: finite")
    strip = lambda fs: [{k: v for k, v in fr.items()  # noqa: E731
                         if k not in ("run_id", "source")} for fr in fs]
    _require(strip(res_series[0]["frames"]) == strip(res_series[1]["frames"]),
             "batch: the RLE series differs from the explicit LE one")
    for path, n in ((f["series"], CLI_SERIES_N), (f["mixed"], n_mixed)):
        again = batch(path, resume=True)
        _require(again["skipped"] == n and again["frames"] == [],
                 f"batch --resume {path}: skipped {again['skipped']} of {n}")
    print(f"batch --resume: skipped all {CLI_SERIES_N} and {n_mixed}")

    # the 512^2 bucket, card against CPU (the CT files alone on the CPU)
    for i, window in enumerate((False, True)):
        on_card = [fr for fr in res_mixed[i]["frames"]
                   if tuple(fr["shape"]) == (CLI_SIZE, CLI_SIZE)]
        cpu = PB.run_pipeline_batch(f["ct_only"], out, device="cpu",
                                    window=window, save_artifacts=False)
        bad = parity.breaches(parity.flatten_batch(on_card),
                              parity.flatten_batch(cpu["frames"]),
                              hw=CLI_SIZE * CLI_SIZE)
        print(f"batch 512^2 bucket card vs cpu (window {window}): "
              f"{len(on_card)} frames, breaches {len(bad)}")
        for line in bad:
            print("  " + line)
        _require([fr["source"] for fr in on_card] == [
            fr["source"] for fr in cpu["frames"]] and not bad,
            f"batch 512^2 bucket: card and CPU disagree (window {window})")
    print(f"phase 12 checks: {time.perf_counter() - t12:.1f} s")

    # 12.3 times, beside the card
    for label, p in ((f"{CLI_SIZE}^2 {CLI_KINDS[0]}", f["noisy"]),
                     (f"{BIG}^2 cxr", f["cxr"])):
        w = CL.warm_runs(p, out, 5, dev)
        phases = ", ".join(f"{k} {v!r}" for k, v in w["phases_ms"].items())
        print(f"cli warm run_pipeline {label} on {card}: median "
              f"{w['median_ms']!r} ms of 5 (runs {w['runs_ms']}); phases "
              f"(median ms): {phases}")
    # one fresh process here; phase 18 times two more (primed, unprimed)
    proc = [CL.process_ms(f["noisy"], out)]
    print(f"cli process latency python -m mdx_torch {CLI_SIZE}^2 on {card}: "
          f"{proc} ms")
    for label, kw, reps in (("raw", {}, 3), ("--autotune",
                                             {"autotune": True}, 2)):
        r = CL.batch_fps(f["series"], out, dev, reps=reps, **kw)
        print(f"batch series [{CLI_SERIES_N},{CLI_SIZE},{CLI_SIZE}] {label} "
              f"on {card}: {r['frames_per_s']!r} frames/s (median "
              f"{r['median_ms']!r} ms of {reps}, runs {r['runs_ms']})")
    r = CL.batch_fps(f["mixed"], out, dev, reps=3)
    print(f"batch mixed directory ({n_mixed} frames) on {card}: "
          f"{r['frames_per_s']!r} frames/s (median {r['median_ms']!r} ms, "
          f"runs {r['runs_ms']})")
    chunk = PB.CHUNK
    try:
        for n in (chunk, 16):
            PB.CHUNK = n
            t = CL.traced_batch(f["series"], out, dev,
                                CL.ROOT / "build" / "chip_smoke_batch.json")
            print(f"batch series traced, chunks of {n} on {card}: {t}")
    finally:
        PB.CHUNK = chunk


# phase 13: --spatial, one large slice sharded over the ranks
SPATIAL_CLI_KINDS = ("noisy", "low_contrast")
# the runner against the port's dense paths on the card: enhanced pixels and
# the sweep's scores to the limits JAX holds its own runner and sweep to
# (tests/test_spatial_runner.py:86, tests/test_spatial_plan.py:131-136)
SPATIAL_CLI_ATOL, SPATIAL_CLI_SCORE_ATOL = 1e-4, 2e-3
SPATIAL_CLI_OPS = ("denoise", "clahe", "gamma", "unsharp", "post_denoise")


def _spatial_cli_run(kernels, parity, check, paths: dict, label: str, fn):
    """One ``--spatial`` run through ``fn`` (→ its context) with its launch
    recorded: exactly one launch; kernel 11 and C's LUT stage launched on
    every rank when CLAHE was applied, rank 0's calls of both within
    ``KERNEL_TOL``; the launches summed over the ranks under ``paths``."""
    from mdx_torch.tools import spatial_check as SC

    with _recorded_launches() as launched:
        got = fn()
    _require(len(launched) == 1,
             f"{label}: {len(launched)} launches, not one")
    res, smoke = launched[0]
    ctx = got["ctx"] if "ctx" in got else got
    per_rank = [sm["launches"] for sm in smoke]
    print(f"launches in {label} ({res.backend}, {len(smoke)} ranks), per "
          f"rank: {per_rank}")
    paths[f"spatial_cli_{label.replace(' ', '_')}"] = {
        k: sum(int(lr[k]) for lr in per_rank) for k in kernels.LAUNCHES}
    if "clahe" in ctx["applied_ops"]:
        for k in ("clahe_remap_ext", "clahe"):
            _require(all(int(lr[k]) > 0 for lr in per_rank),
                     f"{k} not launched on every rank of {label}")
        for name in ("clahe_luts", "clahe_remap_ext"):
            n_calls, err, ok = smoke[0]["replay"][name]
            row = SC.ROW_OF.get(name, name)
            print(f"replayed rank 0 {label} {name}: {int(n_calls)} calls, "
                  f"max|d| {float(err)!r} (tol {parity_tol(row)})")
            check.errs[row] = max(check.errs[row], float(err))
            _require(bool(ok) and int(n_calls) > 0,
                     f"{name} replay {label}: max|d| {float(err)!r}")
    return got, ctx


def _check_spatial_cli(run: dict, path: str, out: str, label: str) -> None:
    """A ``main([... "--spatial"])`` run: rc 0, the printed report equal
    to the written one, its DB row read back."""
    import os

    from mdx_torch.pipeline import storage

    _require(run["rc"] == 0 and run["ctx"] is not None,
             f"{label}: rc {run['rc']}: {run['text'][-500:]}")
    base = os.path.splitext(os.path.basename(path))[0]
    report = open(f"{out}/{base}_spatial_report.md", encoding="utf-8").read()
    _require(run["text"].strip() == report.strip()
             and report.startswith("# mdx spatial QA report"),
             f"{label}: printed report differs from the file")
    row = storage.get_run(run["ctx"]["run_id"])
    _require(row is not None and row["status"] == "completed"
             and row["issues"] == run["ctx"]["issues"],
             f"{label}: DB row {row and row['status']}")


def _spatial_vs_dense(torch, parity, label: str, ctx: dict, x) -> None:
    """A deterministic ``--spatial`` run against the port's dense
    ``qa_deterministic`` on the card on the same frame: issues, applied
    ops and the noise guard equal, ``enhanced`` within SPATIAL_CLI_ATOL,
    the metrics before and after within ``parity.breaches``."""
    import numpy as np

    from mdx_torch.core import qa
    from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS

    enh, stats, issues, flags, val, _ = qa.qa_deterministic(x)
    issues = [k for k in ISSUE_ORDER if bool(issues[k][0])]
    ops = [o for o in SPATIAL_CLI_OPS if bool(flags[o][0])] if issues else []
    guard = bool(flags["noise_amp"][0])
    err = float(np.abs(ctx["enhanced"] - enh[0].cpu().numpy()).max())
    mine = {"stats": {k: np.float32([ctx["metrics"][k]]) for k in
                      METRIC_KEYS},
            "validation": {"metrics_after": {
                k: np.float32([ctx["metrics_after"][k]])
                for k in METRIC_KEYS}}}
    dense = {"stats": {k: stats[k] for k in METRIC_KEYS},
             "validation": {"metrics_after": {
                 k: val["metrics_after"][k] for k in METRIC_KEYS}}}
    bad = parity.breaches(parity.flatten(mine), parity.flatten(dense),
                          hw=x.shape[1] * x.shape[2])
    print(f"{label} vs dense qa_deterministic on the card: issues "
          f"{ctx['issues']} / {issues}, ops {ctx['applied_ops']} / {ops}, "
          f"noise guard {ctx['noise_amp_guard']} / {guard}, enhanced "
          f"max|d| {err!r}, metric breaches {len(bad)}")
    for line in bad:
        print("  " + line)
    _require(ctx["issues"] == issues and ctx["applied_ops"] == ops
             and ctx["noise_amp_guard"] == guard
             and err <= SPATIAL_CLI_ATOL and not bad,
             f"{label} and dense qa_deterministic differ")


def _print_spatial_times(label: str, run: dict, card: str) -> None:
    from mdx_torch.tools import cli_latency as CL

    t = CL.spatial_times(run)
    phases = ", ".join(f"{k} {v!r}" for k, v in t["phases_ms"].items())
    stages = ", ".join(f"{k} {v!r}" for k, v in t["rank_ms"].items())
    print(f"{label} on {card}: wall {t['wall_ms']!r} ms, one launch "
          f"{t['launch']}; phases (ms): {phases}; rank 0 (ms): {stages}")


def _phase_spatial_cli(torch, kernels, parity, check, paths: dict,
                       card: str, dev) -> None:
    """Phase 13: ``python -m mdx_torch --spatial`` on 2048^2 slices
    (module doc), its files and DB in a temporary directory."""
    import os
    import tempfile

    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
        os.environ.pop("MDX_TV_MODE", None)
        _spatial_cli_checks(torch, kernels, parity, check, paths, card, dev,
                            tmp)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")


def _spatial_cli_checks(torch, kernels, parity, check, paths, card, dev,
                        tmp) -> None:
    import numpy as np

    from mdx_torch.core.tuning import autotune
    from mdx_torch.io import load_dicom, normalize_image, write_synthetic_dicom
    from mdx_torch.pipeline.spatial_runner import run_pipeline_spatial
    from mdx_torch.tools import cli_latency as CL

    f = {k: write_synthetic_dicom(f"{tmp}/{k}.dcm", kind=k, size=BIG,
                                  seed=50 + i)
         for i, k in enumerate(SPATIAL_CLI_KINDS)}
    out = f"{tmp}/out"
    frames = {k: normalize_image(load_dicom(p)[0]) for k, p in f.items()}

    # 13.1 main([... "--spatial"]) on each file: k = 1 over NCCL
    det = {}
    for k, p in f.items():
        label = f"--spatial {k} [1,{BIG},{BIG}]"
        run, ctx = _spatial_cli_run(
            kernels, parity, check, paths, f"{k} k1",
            lambda p=p: CL.spatial_cli(p, out, dev))
        _check_spatial_cli(run, p, out, label)
        _print_spatial_times(label, run, card)
        x = torch.from_numpy(frames[k])[None].to(dev)
        _spatial_vs_dense(torch, parity, label, ctx, x)
        det[k] = ctx
    check.require_ok()

    # 13.2 --autotune on the low-contrast file against the dense sweep
    p = f["low_contrast"]
    label = f"--spatial --autotune low_contrast [1,{BIG},{BIG}]"
    run, ctx = _spatial_cli_run(
        kernels, parity, check, paths, "low_contrast k1 autotune",
        lambda: CL.spatial_cli(p, out, dev, "--autotune"))
    _check_spatial_cli(run, p, out, label)
    _print_spatial_times(label, run, card)
    plan, enh, recs = autotune(frames["low_contrast"], ctx["issues"],
                               device=dev)
    mine = ctx["iterations"]
    err = float(np.abs(ctx["enhanced"] - enh).max())
    worst = max(abs(a.score - b.score) for a, b in zip(mine, recs))
    print(f"{label} vs dense autotune on the card: {len(mine)} / "
          f"{len(recs)} candidates, chosen "
          f"{[r.iteration for r in mine if r.chosen]} / "
          f"{[r.iteration for r in recs if r.chosen]}, scores max|d| "
          f"{worst!r}, gamma {ctx['plan'].params.gamma} / "
          f"{plan.params.gamma}, clip {ctx['plan'].params.clahe_clip_limit}"
          f" / {plan.params.clahe_clip_limit}, enhanced max|d| {err!r}")
    print(f"{label} on {card}: {len(mine)} candidates, "
          f"{ctx['rank_ms']['per_candidate']!r} ms a candidate, sweep "
          f"{ctx['rank_ms']['sweep']!r} ms, the run's one launch "
          f"{ctx['phase_ms']['launch']!r} ms")
    _require(len(mine) == len(recs)
             and [r.chosen for r in mine] == [r.chosen for r in recs]
             and worst <= SPATIAL_CLI_SCORE_ATOL
             and ctx["plan"].params.gamma == plan.params.gamma
             and (ctx["plan"].params.clahe_clip_limit
                  == plan.params.clahe_clip_limit)
             and err <= SPATIAL_CLI_ATOL,
             f"{label} and the dense autotune differ")
    check.require_ok()

    # 13.3 the 2 x 2 grid: four gloo ranks on the one card
    label = f"run_pipeline_spatial low_contrast n_space=(2, 2) [1,{BIG},{BIG}]"
    t0 = time.perf_counter()
    ctx, _ = _spatial_cli_run(
        kernels, parity, check, paths, "low_contrast 2x2",
        lambda: run_pipeline_spatial(p, f"{tmp}/out_2x2", n_space=(2, 2),
                                     device=dev))
    wall = (time.perf_counter() - t0) * 1e3
    _print_spatial_times(label + " (four ranks on one card over gloo: host "
                         "staging, not scaling)",
                         {"wall_ms": wall, "ctx": ctx}, card)
    one = det["low_contrast"]
    bad = parity.breaches({"enhanced": ctx["enhanced"][None]},
                          {"enhanced": one["enhanced"][None]})
    print(f"{label} vs k = 1: issues {ctx['issues']} / {one['issues']}, "
          f"ops {ctx['applied_ops']} / {one['applied_ops']}, noise guard "
          f"{ctx['noise_amp_guard']} / {one['noise_amp_guard']}, passes "
          f"{ctx['validation']['passes']} / {one['validation']['passes']},"
          f" enhanced max|d| "
          f"{float(np.abs(ctx['enhanced'] - one['enhanced']).max())!r}, "
          f"breaches {len(bad)}")
    _require(all(ctx[k] == one[k] for k in ("issues", "applied_ops",
                                            "noise_amp_guard"))
             and ctx["validation"]["passes"] == one["validation"]["passes"]
             and not bad, f"{label} and k = 1 differ")
    check.require_ok()


# phase 14: the data axis (BASELINE config 3 across ranks); on one card the
# d = 2 ranks share it over gloo: contention, not scaling
DATA_N, DATA_D, DATA_REPS = 63, 2, 3
STREAM_N, STREAM_BATCH = 64, 16
CONTENTION = "two gloo ranks on one card: contention, not scaling"


@contextlib.contextmanager
def _recorded_launches(recorded=None):
    """Every ``launch.run`` made meanwhile runs its rank function inside
    ``spatial_check.recorded_rank`` (each rank's counters reset, rank 0's
    calls of the wrappers ``recorded`` — default kernels 11 and C's LUT
    stage — recorded and replayed); yields the list of (Launched, per-rank
    ``smoke`` dicts), the ``smoke`` keys taken out of the results so that
    the caller assembles them as usual."""
    import functools

    from mdx_torch.parallel import launch
    from mdx_torch.tools import spatial_check as SC

    real, launched = launch.run, []
    wrap = functools.partial(SC.recorded_rank,
                             recorded=recorded or SC.RECORDED)

    def run(fn, *args, **kwargs):
        res = real(functools.partial(wrap, inner=fn), *args, **kwargs)
        launched.append((res, [r.pop("smoke") for r in res.results]))
        return res

    launch.run = run
    try:
        yield launched
    finally:
        launch.run = real


@contextlib.contextmanager
def _recorded_pool_calls(recorded):
    """Every rank-pool call made meanwhile runs its rank function inside
    ``spatial_check.recorded_rank`` (as :func:`_recorded_launches`; rank 0
    is this process); yields a list of each call's per-rank ``smoke``
    dicts, taken out of the results."""
    import functools

    from mdx_torch.parallel import pool
    from mdx_torch.tools import spatial_check as SC

    call, called = pool.RankPool.call, []

    def recording(self, fn, args, **kwargs):
        res = call(self, functools.partial(SC.recorded_rank, inner=fn,
                                           recorded=recorded),
                   args, **kwargs)
        called.append([r.pop("smoke") for r in res])
        return res

    pool.RankPool.call = recording
    try:
        yield called
    finally:
        pool.RankPool.call = call


def _data_ranks(kernels, check, paths: dict, label: str, smoke: list,
                need) -> None:
    """A data-axis launch's per-rank counters and rank 0's replay of the
    dense kernels: each of ``need`` launched on every rank, every replayed
    call within ``KERNEL_TOL`` (T: equal iteration counts); the launches
    summed over the ranks under ``paths[label]``."""
    per_rank = [sm["launches"] for sm in smoke]
    print(f"launches in {label} ({len(smoke)} ranks), per rank: {per_rank}")
    paths[label] = {k: sum(int(lr[k]) for lr in per_rank)
                    for k in kernels.LAUNCHES}
    for k in need:
        _require(all(int(lr[k]) > 0 for lr in per_rank),
                 f"{k} not launched on every rank of {label}")
    for name, (n_calls, err, ok) in smoke[0]["replay"].items():
        print(f"replayed rank 0 {label} {name}: {int(n_calls)} calls, "
              f"max|d| {float(err)!r} (tol {parity_tol(name)})")
        check.errs[name] = max(check.errs[name], float(err))
        if not ok or (name in need and not int(n_calls)):
            check.failed.append(f"{label} {name} replay: max|d| "
                                f"{float(err)!r}, {int(n_calls)} calls")
    check.require_ok()


def _phase_data(torch, kernels, parity, check, paths: dict, card: str,
                dev) -> None:
    """Phase 14: the data axis (module doc), its files and DB in a
    temporary directory."""
    import os
    import tempfile

    t14 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
        _data_sharded(torch, kernels, parity, check, paths, card, dev)
        _data_runner(kernels, parity, check, paths, card, dev, tmp)
        _data_stream(torch, card, dev, tmp)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")


def _data_sharded(torch, kernels, parity, check, paths, card, dev) -> None:
    """14.1: the three sharded entry points at d = 1 in this process and
    their rank bodies at d = 2 in one launch; 14.4's times of both."""
    import statistics

    import numpy as np

    from mdx_torch.parallel import batch as PB
    from mdx_torch.tools import data_check as DC
    from mdx_torch.tools import make_batch

    x = make_batch(DATA_N)
    xp, n_valid = PB.pad_batch(x, DATA_D)
    n = len(xp)
    _require(n == 64 and n_valid == DATA_N,
             f"pad_batch({DATA_N} images, {DATA_D}): {n}, {n_valid}")
    static, dyn = _bench_plan(dev)
    det, valid_d = PB.qa_deterministic_sharded(x, 1, dev)
    plan, valid_p = PB.qa_plan_sharded(x, static, dyn, 1, dev)
    *detect, valid_t = PB.detect_sharded(x, 1, dev)
    _require(valid_d == valid_p == valid_t == n_valid and not PB.LAST_LAUNCH,
             f"the sharded steps at n_data = 1: valid {valid_d}, {valid_p}, "
             f"{valid_t}, launch {PB.LAST_LAUNCH}")
    one = {"qa_deterministic": dict(zip(PB.DETERMINISTIC_FIELDS, det)),
           "qa_plan": dict(zip(PB.PLAN_FIELDS, plan)),
           "detect": dict(zip(PB.DETECT_FIELDS, detect))}
    label = f"[{n},512,512] n_data = {DATA_D}"
    many = DC.launch_check(xp, *_bench_plan("cpu"), DATA_D, DATA_REPS)
    _data_ranks(kernels, check, paths, "data_sharded", many["smoke"],
                DENSE_KERNELS)
    for name, how in DC.agreement(one, many["outs"], n_valid,
                                       512 * 512).items():
        flat = parity.flatten(many["outs"][name])
        for k, v in flat.items():
            _require(k == "rank_ms" or v.shape[0] == n and (
                v.dtype == bool or k.endswith("psnr")
                or bool(np.isfinite(v).all())),
                f"{name} {label}: {k} shape {v.shape} or non-finite")
        print(f"{name} {label} vs n_data = 1: bit-equal {how['equal']}, "
              f"max|d| {how['max_abs']!r}, breaches {len(how['breaches'])}"
              f"; finite")
        for line in how["breaches"]:
            print("  " + line)
        _require(not how["breaches"],
                 f"{name}: n_data = {DATA_D} and n_data = 1 differ")

    # 14.4 times: the bodies at d = 1 in this process, at d = 2 in the
    # ranks (their median calls), the launch wall and each rank's compute
    local = DC.local_check(xp, static, dyn, DATA_REPS, dev)
    for name in DC.BODIES:
        ranks = [statistics.median(m[name]) for m in many["ms"]]
        print(f"data axis {name} [{n},512,512] on {card}: n_data = 1 "
              f"{DC.img_per_s(n, [local['ms'][name]])!r} img/s (ms "
              f"{local['ms'][name]}); n_data = {DATA_D} ({CONTENTION}) "
              f"{DC.img_per_s(n, [m[name] for m in many['ms']])!r} img/s, "
              f"rank medians {ranks} ms")
    rank_ms = {name: many["outs"][name]["rank_ms"].tolist()
               for name in DC.BODIES}
    print(f"data axis launch on {card} ({CONTENTION}): wall "
          f"{many['wall_ms']!r} ms, {many['info']}; each rank's first "
          f"(recorded) call, ms: {rank_ms}")


def _data_runner(kernels, parity, check, paths, card, dev, tmp) -> None:
    """14.2: ``run_pipeline_batch`` on the 64-frame 512^2 12-bit series at
    n_data = 2 (one launch) against n_data = 1."""
    from mdx_torch.pipeline import batch_runner as PB
    from mdx_torch.tools import cli_latency as CL
    from mdx_torch.tools import spatial_check as SC

    series = CL.series_file(f"{tmp}/series.dcm", CLI_SERIES_N, CLI_SIZE)
    one = PB.run_pipeline_batch(series, f"{tmp}/o1", device=dev, n_data=1)
    label = f"run_pipeline_batch series [{CLI_SERIES_N},{CLI_SIZE}," \
            f"{CLI_SIZE}] n_data = {DATA_D}"
    walls = []
    with _recorded_pool_calls(SC.DENSE_RECORDED) as called:
        for k in range(2):
            t0 = time.perf_counter()
            two = PB.run_pipeline_batch(series, f"{tmp}/o2_{k}", device=dev,
                                        n_data=DATA_D)
            walls.append((time.perf_counter() - t0) * 1e3)
            print(f"{label} call {k}: {walls[-1]!r} ms, ranks started "
                  f"{two['launch']['starts']}")
    wall = walls[-1]
    _require(len(called) == 2 and two["launch"]["starts"] == 0,
             f"{label}: {len(called)} pool calls, {two['launch']['starts']}"
             f" ranks started by the second")
    _require(one["mesh"] == {"data": 1, "space": 1} and one["launch"] is None
             and two["mesh"] == {"data": DATA_D, "space": 1},
             f"{label}: mesh {one['mesh']} / {two['mesh']}")
    _data_ranks(kernels, check, paths, "data_runner", called[-1],
                ("box_stats", "wavelet_denoise"))
    a, b = one["frames"], two["frames"]
    same = [(f["source"], f["frame"], f["issues"], f["passed"]) for f in a]
    bad = parity.breaches(parity.flatten_batch(b), parity.flatten_batch(a),
                          hw=CLI_SIZE * CLI_SIZE)
    strip = [{k: v for k, v in f.items() if k != "run_id"} for f in a]
    equal = strip == [{k: v for k, v in f.items() if k != "run_id"}
                      for f in b]
    print(f"{label} vs n_data = 1: {len(b)} / {len(a)} frames, records "
          f"equal {equal}, breaches {len(bad)}, mesh {two['mesh']}")
    for line in bad:
        print("  " + line)
    _require(len(a) == CLI_SERIES_N and same == [
        (f["source"], f["frame"], f["issues"], f["passed"]) for f in b]
        and not bad, f"{label} and n_data = 1 differ")
    print(f"{label} on {card} ({CONTENTION}): wall {wall!r} ms, "
          f"{CLI_SERIES_N / wall * 1e3!r} frames/s; launch "
          f"{two['launch']}")


def _data_stream(torch, card, dev, tmp) -> None:
    """14.3: ``stream_batches`` over 64 single-frame 512^2 files into
    ``qa_deterministic`` against decoding all first; frames/s of both and
    the uploads that overlapped a kernel in one traced run."""
    import numpy as np

    from mdx_torch.io import write_synthetic_dicom
    from mdx_torch.tools import data_check as DC
    from mdx_torch.tools.cli_latency import ROOT

    paths = [write_synthetic_dicom(f"{tmp}/frame{i:02d}.dcm",
                                   kind=CLI_KINDS[i % 3], size=CLI_SIZE,
                                   seed=60 + i) for i in range(STREAM_N)]
    DC.stream_qa(paths, STREAM_BATCH, dev)  # warm-up
    streamed, ms_s = DC.stream_qa(paths, STREAM_BATCH, dev)
    whole, ms_w = DC.decode_all_qa(paths, STREAM_BATCH, dev)
    equal = [s for s, _ in streamed] == [s for s, _ in whole] and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k],
                                                    equal_nan=True)
                                     for k in a)
        for (_, a), (_, b) in zip(streamed, whole))
    label = f"stream_batches {STREAM_N} files {CLI_SIZE}^2, batches of " \
            f"{STREAM_BATCH}, into qa_deterministic"
    print(f"{label}: equal to decoding all first {equal}")
    _require(equal, f"{label} and decode-all-then-QA differ")
    t = DC.traced_stream(paths, STREAM_BATCH, dev,
                         ROOT / "build" / "chip_smoke_stream.json")
    print(f"{label} on {card}: {STREAM_N / ms_s * 1e3!r} frames/s "
          f"({ms_s!r} ms); decode all, then QA: {STREAM_N / ms_w * 1e3!r} "
          f"frames/s ({ms_w!r} ms); traced: {t}")


# phase 15: the lossless JPEG codecs, compressed files through the CLI
# .4.70, .4.80 and .4.90, written as phase 12's files
CODEC_SYNTAXES = ("ll", "ls", "j2k")
CODEC_SERIES_REPS = 3
# the committed .4.91 codestreams (Pillow's OpenJPEG, irreversible 9/7;
# tests/test_torch_jpeg2k.py made them): a 512^2 12-bit CT slice and a
# tiled, two-layer YBR_ICT colour image of 96 x 80
J2K_FIXTURES = "tests/torch_fixtures/j2k"
J2K_PY_SIZE = 128            # the frame both Tier-1 loops code (Python: ~1 s)
_PIXEL_ITEMS = b"\xe0\x7f\x10\x00OB\x00\x00\xff\xff\xff\xff"


def _refragment(src: str, dst: str, frags: list, uid_from: str,
                uid_to: str) -> str:
    """``src`` with its encapsulated frames replaced by ``frags`` and its
    transfer syntax UID rewritten (both UIDs are 22 characters, as JAX's
    tests rewrite them)."""
    import struct

    raw = open(src, "rb").read()
    i = raw.index(_PIXEL_ITEMS) + len(_PIXEL_ITEMS)
    items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
    for f in frags:
        f += b"\x00" * (len(f) % 2)
        items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f)
    items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    _require(len(uid_from) == len(uid_to), "UIDs of unequal length")
    with open(dst, "wb") as fh:
        fh.write(raw[:i].replace(uid_from.encode(), uid_to.encode(), 1)
                 + b"".join(items))
    return dst


def _codec_inputs(root) -> tuple[dict, object]:
    """Phase 15's files: phase 12's pixels written again in explicit LE
    (``le``), ``.4.70`` (``ll``), ``.4.80`` (``ls``) and ``.4.90``
    (``j2k``), each syntax in a directory of its own under the same names;
    a ``.4.57`` file of the noisy slice at predictor 7 and a ``.4.81`` file
    of the blurred phantom at NEAR 2, with the ``.4.81`` file's decoded
    pixels in explicit LE as its twin; the two ``.4.91`` fixtures wrapped
    as DICOM files (``j2k91``), the CT slice's decoded pixels in explicit
    LE as its twin.  Returns the files by (syntax, name) and the blurred
    phantom's pixels, the ``.4.81`` file's source."""
    import os
    from pathlib import Path

    import numpy as np

    from mdx_torch.io import jpegll, jpegls, write_dicom, write_synthetic_dicom
    from mdx_torch.io.dicom import (TS_EXPLICIT_LE, TS_J2K, TS_J2K_LOSSLESS,
                                    TS_JPEG_LL, TS_JPEG_LL_SV1, TS_JPEG_LS,
                                    TS_JPEG_LS_NEAR, decode_pixels,
                                    read_dataset)
    from mdx_torch.io.dicom_write import write_codestreams
    from mdx_torch.tools import make_batch

    cxr = np.rint(make_batch(1, BIG, seed=8)[0] * 65535).astype(np.uint16)
    blurred = _blurred_phantom(CLI_SIZE)
    f = {}
    for syn, ts in (("le", TS_EXPLICIT_LE), ("ll", TS_JPEG_LL_SV1),
                    ("ls", TS_JPEG_LS), ("j2k", TS_J2K_LOSSLESS)):
        d = f"{root}/{syn}"
        os.makedirs(d)
        for i, kind in enumerate(CLI_KINDS[:3]):
            f[syn, kind] = write_synthetic_dicom(
                f"{d}/{kind}.dcm", kind=kind, size=CLI_SIZE, seed=20 + i,
                transfer_syntax=ts)
        f[syn, "blurred"] = write_dicom(
            f"{d}/blurred.dcm", blurred, rescale_slope=1.0,
            rescale_intercept=-1024.0, transfer_syntax=ts)
        f[syn, "cxr"] = write_dicom(f"{d}/cxr.dcm", cxr, modality="DX",
                                    body_part="CHEST",
                                    study_description="CXR PA",
                                    transfer_syntax=ts)
        f[syn, "series"] = write_synthetic_dicom(
            f"{d}/series.dcm", kind="phantom", size=CLI_SIZE,
            frames=CLI_SERIES_N, seed=3, transfer_syntax=ts)
    for d in ("p14", "near", "near_le", "j2k91", "j2k91_le"):
        os.makedirs(f"{root}/{d}")
    noisy = decode_pixels(read_dataset(f["le", "noisy"]))
    f["p14", "noisy"] = _refragment(
        f["ll", "noisy"], f"{root}/p14/noisy.dcm",
        [jpegll.encode(noisy, precision=16, predictor=7)], TS_JPEG_LL_SV1,
        TS_JPEG_LL)
    f["near", "blurred"] = _refragment(
        f["ls", "blurred"], f"{root}/near/blurred.dcm",
        [jpegls.encode(blurred, precision=16, near=2)], TS_JPEG_LS,
        TS_JPEG_LS_NEAR)
    f["near_le", "blurred"] = write_dicom(
        f"{root}/near_le/blurred.dcm",
        decode_pixels(read_dataset(f["near", "blurred"])),
        rescale_slope=1.0, rescale_intercept=-1024.0)
    fixtures = Path(__file__).resolve().parent / J2K_FIXTURES
    f["j2k91", "ct"] = write_codestreams(
        f"{root}/j2k91/ct.dcm", [(fixtures / "ct512_97.j2k").read_bytes()],
        512, 512, transfer_syntax=TS_J2K)
    f["j2k91_le", "ct"] = write_dicom(
        f"{root}/j2k91_le/ct.dcm",
        decode_pixels(read_dataset(f["j2k91", "ct"])))
    f["j2k91", "rgb"] = write_codestreams(
        f"{root}/j2k91/rgb.dcm",
        [(fixtures / "rgb_ict_tiled.j2k").read_bytes()], 96, 80,
        transfer_syntax=TS_J2K, bits=8, samples=3, photometric="YBR_ICT",
        modality="OT")
    return f, blurred


# the committed DCT JPEG codestreams (tests/test_torch_jpegdct.py made them:
# Pillow's libjpeg and a test-only SOF1 encoder): a 512^2 8-bit slice with
# restart intervals and the same progressive, a 480 x 640 colour ultrasound
# frame at YBR 4:2:2, a 256^2 12-bit slice (.4.51)
DCT_FIXTURES = "tests/torch_fixtures/jpegdct"
DCT_FILES = {"ct_rst": ("ct512_rst.jpg", (512, 512), {}),
             "ct_prog": ("ct512_prog.jpg", (512, 512), {}),
             "us": ("us480x640_422.jpg", US_SHAPE,
                    {"samples": 3, "photometric": "YBR_FULL_422",
                     "modality": "US", "body_part": "ABDOMEN"}),
             "ct12": ("ct256_12bit.jpg", (256, 256), {})}
DCT_SERIES_N = 16
SERIES_N = {"dct": DCT_SERIES_N}


def _dct_inputs(root, f: dict) -> None:
    """Phase 15's DCT JPEG files, added to ``f``: the four fixtures wrapped
    as DICOM files (``dct``; ``.4.51`` for the 12-bit one, ``.4.50`` for the
    rest), a ``DCT_SERIES_N``-frame ``.4.50`` series of the two 512^2
    streams in turns, and a copy of phase 12's mixed directory whose 8
    ultrasound files are the ``.4.50`` colour frame (``dct_mixed``).  Each
    file's twin is its transcode to explicit LE (``dct_le``,
    ``dct_mixed_le``): the same pixels, uncompressed."""
    import os
    import shutil
    from pathlib import Path

    from mdx_torch.io import transcode
    from mdx_torch.io.dicom import TS_JPEG_BASELINE, TS_JPEG_EXTENDED
    from mdx_torch.io.dicom_write import write_codestreams

    fx = Path(__file__).resolve().parent / DCT_FIXTURES
    for d in ("dct", "dct_le", "dct_mixed", "dct_mixed_le"):
        os.makedirs(f"{root}/{d}")
    streams = {}
    for name, (fname, (h, w), kw) in DCT_FILES.items():
        streams[name] = (fx / fname).read_bytes()
        twelve = name == "ct12"
        f["dct", name] = write_codestreams(
            f"{root}/dct/{name}.dcm", [streams[name]], h, w,
            transfer_syntax=TS_JPEG_EXTENDED if twelve else TS_JPEG_BASELINE,
            bits=16 if twelve else 8, **kw)
    f["dct", "series"] = write_codestreams(
        f"{root}/dct/series.dcm",
        [streams[("ct_rst", "ct_prog")[i % 2]] for i in range(DCT_SERIES_N)],
        512, 512, transfer_syntax=TS_JPEG_BASELINE, bits=8)
    for name in list(DCT_FILES) + ["series"]:
        f["dct_le", name] = transcode(f["dct", name],
                                      f"{root}/dct_le/{name}.dcm",
                                      "explicit-le")
    mixed, twin = f"{root}/dct_mixed", f"{root}/dct_mixed_le"
    _mixed_ct_cxr(mixed)
    for name in os.listdir(mixed):
        shutil.copyfile(f"{mixed}/{name}", f"{twin}/{name}")
    for i in range(MIXED_US):
        shutil.copyfile(f["dct", "us"], f"{mixed}/us{i}.dcm")
        shutil.copyfile(f["dct_le", "us"], f"{twin}/us{i}.dcm")
    f["dct_mixed", "dir"], f["dct_mixed_le", "dir"] = mixed, twin


def _codec_pixels(native, f: dict, blurred) -> None:
    """15.2: every lossless file's pixels equal to its explicit-LE twin's;
    the ``.4.81`` file within 2 of its source and equal to its decode
    through the Python loops; one 512^2 frame of each lossless JPEG family
    through the host loops and the Python loops, encode and decode equal;
    JPEG 2000: the 512^2 frame encoded and decoded through the host loops,
    its 128^2 corner and the ``.4.91`` colour fixture through both."""
    import numpy as np

    from mdx_torch.io import jpeg2k, jpegll, jpegls
    from mdx_torch.io.dicom import decode_pixels, read_dataset
    from mdx_torch.tools.time_codecs import python_loops

    native.reset_calls()
    pix = lambda p: decode_pixels(read_dataset(p))  # noqa: E731
    n = 0
    for (syn, name), p in f.items():
        if syn in ("ll", "ls", "p14", "j2k"):
            want = pix(f["le", name])
            got = pix(p)
            _require(got.dtype == want.dtype and np.array_equal(got, want),
                     f"codecs: {syn} {name} differs from its explicit-LE "
                     "twin")
            n += 1
    near = pix(f["near", "blurred"])
    err = int(np.abs(near.astype(np.int64)
                     - blurred.astype(np.int64)).max())
    with python_loops():
        near_py = pix(f["near", "blurred"])
    _require(err <= 2 and np.array_equal(near, near_py),
             f"codecs: .4.81 max|d| {err} or its Python decode differs")
    print(f"codecs pixels: {n} lossless files bit-equal to their explicit-LE "
          f"twins; .4.81 NEAR 2 max|d| {err} from its source, equal to its "
          "Python-loop decode")
    frame = pix(f["le", "noisy"])
    for name, mod, kw in (("jpegll", jpegll, {"predictor": 1}),
                          ("jpegls", jpegls, {})):
        enc = mod.encode(frame, precision=16, **kw)
        dec = mod.decode(enc)[0]
        with python_loops():
            enc_py = mod.encode(frame, precision=16, **kw)
            dec_py = mod.decode(enc)[0]
        _require(enc == enc_py and np.array_equal(dec, dec_py)
                 and np.array_equal(dec, frame),
                 f"codecs: {name} host loops and Python loops differ")
        print(f"codecs {name} [{CLI_SIZE},{CLI_SIZE}]: host and Python "
              f"loops encode {len(enc)} bytes alike and decode alike")
    enc = jpeg2k.encode(frame)
    dec, prec, signed = jpeg2k.decode(enc)
    _require(np.array_equal(dec, frame) and dec.dtype == frame.dtype
             and (prec, signed) == (16, False),
             "codecs: jpeg2k 512^2 round trip through the host loops")
    print(f"codecs jpeg2k [{CLI_SIZE},{CLI_SIZE}]: host loops encode "
          f"{len(enc)} bytes, decode bit-equal to the frame")
    corner = np.ascontiguousarray(frame[:J2K_PY_SIZE, :J2K_PY_SIZE])
    rgb = read_dataset(f["j2k91", "rgb"]).fragments[0]
    enc = jpeg2k.encode(corner)
    got = (enc, jpeg2k.decode(enc)[0], jpeg2k.decode(rgb)[0])
    with python_loops():
        want = (jpeg2k.encode(corner), jpeg2k.decode(enc)[0],
                jpeg2k.decode(rgb)[0])
    _require(got[0] == want[0] and np.array_equal(got[1], corner)
             and all(np.array_equal(a, b) for a, b in zip(got[1:], want[1:])),
             "codecs: jpeg2k host loops and Python loops differ")
    print(f"codecs jpeg2k [{J2K_PY_SIZE},{J2K_PY_SIZE}]: host and Python "
          f"loops encode {len(enc)} bytes alike and decode alike; the .4.91 "
          f"colour fixture {got[2].shape} decodes alike through both")
    _dct_pixels(f)
    print(f"codecs native.CALLS: {dict(native.CALLS)}")
    _require(all(v > 0 for v in native.CALLS.values()),
             f"codecs: a host entry point was not used: {native.CALLS}")


def _dct_pixels(f: dict) -> None:
    """15.2, DCT JPEG and PackBits: each DCT file's pixels equal to its
    explicit-LE twin's (the colour frame YBR, 3 samples; the 12-bit slice
    uint16); each fixture decoded alike through the host loops and the
    Python loops (the CPU tests hold the same decodes to the JAX package's
    and to the pixels they were made from); a 512^2 frame's RLE fragment
    (PackBits) encoded and decoded alike through both."""
    import numpy as np

    from mdx_torch.io import jpegdct, rle
    from mdx_torch.io.dicom import decode_pixels, read_dataset
    from mdx_torch.tools.time_codecs import dct_fixtures, python_loops

    pix = lambda p: decode_pixels(read_dataset(p))  # noqa: E731
    for name in list(DCT_FILES) + ["series"]:
        got, want = pix(f["dct", name]), pix(f["dct_le", name])
        _require(got.dtype == want.dtype and got.shape == want.shape
                 and np.array_equal(got, want),
                 f"codecs: dct {name} differs from its explicit-LE twin")
        print(f"codecs dct {name}: {got.shape} {got.dtype} equal to its "
              "explicit-LE twin")
    for name, stream in dct_fixtures().items():
        host = jpegdct.decode(stream)
        with python_loops():
            py = jpegdct.decode(stream)
        _require(host[1] == py[1] and np.array_equal(host[0], py[0]),
                 f"codecs: {name} host and Python loops differ")
        print(f"codecs jpegdct {name} {host[0].shape} P={host[1]}: host and "
              "Python loops decode alike")
    frame = pix(f["le", "noisy"])
    enc = rle.encode_frame(frame)
    dec = rle.decode_frame(enc, *frame.shape, 1, 2)
    with python_loops():
        enc_py = rle.encode_frame(frame)
        dec_py = rle.decode_frame(enc, *frame.shape, 1, 2)
    _require(enc == enc_py and np.array_equal(dec, dec_py)
             and np.array_equal(dec.reshape(frame.shape), frame),
             "codecs: PackBits host and Python loops differ")
    print(f"codecs rle [{CLI_SIZE},{CLI_SIZE}]: host and Python PackBits "
          f"encode {len(enc)} bytes alike and decode alike")


def _transcode_check(job) -> bool:
    """``job`` = (source, target alias, output path): transcode, read back,
    and compare with the source's decode (the pixels, their dtype and the
    transfer syntax).  Runs in a worker process of
    :func:`_codec_transcodes`."""
    import os

    import numpy as np

    from mdx_torch.io import transcode
    from mdx_torch.io.dicom import decode_pixels, read_dataset
    from mdx_torch.io.transcode import TARGET_ALIASES

    src, target, out = job
    want = decode_pixels(read_dataset(src))
    transcode(src, out, target)
    ds = read_dataset(out)
    got = decode_pixels(ds)
    os.unlink(out)
    return (ds.transfer_syntax == TARGET_ALIASES[target]
            and got.dtype == want.dtype and np.array_equal(got, want))


def _codec_transcodes(f: dict) -> None:
    """15.5: for each (source syntax, target syntax) pair of the phase's
    files, the smallest file of that syntax the transcoder accepts the
    target for (a colour source: explicit LE and deflated only),
    transcoded on the host and read back: its pixels equal to the
    source's decode.  The transcodes run largest source first on a pool
    of one process a core (``spawn``: the workers import the codecs and
    never touch the card)."""
    import concurrent.futures as cf
    import multiprocessing
    import os
    import tempfile

    from mdx_torch.io.dicom import read_dataset
    from mdx_torch.io.transcode import TARGET_ALIASES

    t0 = time.perf_counter()
    files = sorted({p for p in f.values() if p.endswith(".dcm")},
                   key=os.path.getsize)
    pairs: dict = {}
    for src in files:
        ds = read_dataset(src)
        colour = (ds.get("SamplesPerPixel", 1) or 1) > 1
        for target in TARGET_ALIASES:
            if not colour or target in ("explicit-le", "deflated"):
                pairs.setdefault((ds.transfer_syntax, target), src)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_transcode_") as tmp:
        jobs = sorted(((src, target, f"{tmp}/{i}_{target}.dcm")
                       for i, ((_, target), src) in enumerate(pairs.items())),
                      key=lambda j: os.path.getsize(j[0]), reverse=True)
        with cf.ProcessPoolExecutor(
                os.cpu_count() or 1,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            ok = list(ex.map(_transcode_check, jobs))
    bad = [j[:2] for j, good in zip(jobs, ok) if not good]
    print(f"codecs transcode: {len(pairs)} (source, target) syntax pairs "
          f"from {len({j[0] for j in jobs})} of {len(files)} files, read "
          f"back pixel-equal {len(jobs) - len(bad)} "
          f"({time.perf_counter() - t0:.1f} s, {os.cpu_count()} processes)")
    _require(not bad, f"codecs transcode: pixels differ in {bad}")


def _row_of(path: str):
    import os

    from mdx_torch.pipeline import storage

    runs = [r for r in storage.list_runs(limit=1000)
            if r["input_filename"] == os.path.basename(path)]
    return storage.get_run(runs[0]["run_id"])


def _records(row: dict) -> dict:
    val = row["validation"] or {}
    return {"issues": row["issues"], "ops": row["applied_ops"],
            "status": row["status"],
            "flags": {k: v for k, v in val.items() if isinstance(v, bool)}}


def _metric_tree(rows: list) -> dict:
    import numpy as np

    tree = {"stats": {k: np.float32([r["metrics_before"][k] for r in rows])
                      for k in rows[0]["metrics_before"]}}
    if rows[0]["metrics_after"]:
        tree["metrics_after"] = {
            k: np.float32([r["metrics_after"][k] for r in rows])
            for k in rows[0]["metrics_after"]}
    return tree


def _against_twin(parity, label: str, got: dict, want: dict, hw: int,
                  bit: bool, what: str = "its explicit-LE twin") -> None:
    """A run's records equal to ``what``'s (its explicit-LE twin's), its
    metrics within ``parity.breaches``; prints whether they are
    bit-equal."""
    bad = parity.breaches(parity.flatten(got["metrics"]),
                          parity.flatten(want["metrics"]), hw=hw)
    print(f"{label} vs {what}: records "
          f"{got['records'] == want['records']}, metric breaches {len(bad)}, "
          f"bit-equal {bit}")
    for line in bad:
        print("  " + line)
    _require(got["records"] == want["records"] and not bad,
             f"{label}: differs from {what}")


# phase 15's CLI paths: (launch path, the single files' syntaxes, the
# series' syntaxes, the file whose deterministic run's kernel calls are
# replayed); the JPEG 2000 files are a path of their own
CODEC_PATHS = (("codecs", ("ll", "ls", "p14", "near"), ("ll", "ls"),
                ("ll", "blurred")),
               ("codecs_j2k", ("j2k", "j2k91"), ("j2k",), ("j2k", "blurred")),
               ("codecs_dct", ("dct",), ("dct",), ("dct", "ct_rst")))
TWIN_DIR = {"near": "near_le", "j2k91": "j2k91_le", "dct": "dct_le"}
# pixels a frame of the files that are not CLI_SIZE^2
FILE_HW = {"cxr": BIG * BIG, "rgb": 96 * 80, "ct": 512 * 512,
           "us": US_SHAPE[0] * US_SHAPE[1], "ct12": 256 * 256}


def _codec_cli(torch, kernels, parity, check, paths, dev, f: dict,
               path: str, single_syns, series_syns, recorded,
               cache: dict) -> None:
    """15.3: ``main`` on every single file of ``single_syns``
    (deterministic and ``--autotune``) and ``--batch`` on the series of
    ``series_syns`` (raw and ``--autotune``), counters reset just before and
    read just after as ``paths[path]``; each run held to its explicit-LE
    twin's (the twins' runs kept in ``cache`` across calls; a series' twin
    is the ``le`` series unless ``TWIN_DIR`` names another); B, U, C and 10
    launched; ``recorded``'s deterministic run's kernel calls replayed.  A
    ``.4.91`` file's deterministic run is also held to its run on the CPU
    (the colour fixture has no twin)."""
    import os

    import numpy as np

    from mdx_torch import __main__ as cli
    from mdx_torch.pipeline import batch_runner as PB

    singles = [k for k in f if k[0] in single_syns and k[1] != "series"]
    twin_syn = lambda syn: TWIN_DIR.get(syn, "le")  # noqa: E731
    twin_of = lambda k: f.get((twin_syn(k[0]), k[1]))  # noqa: E731
    recording = [False]
    runs = []

    def one(p, auto, device=dev):
        d = os.path.dirname(p)
        argv = ["--input", p, "--output", f"{d}/out", "--no-show"]
        recording[0] = p == f[recorded] and not auto
        rc, text = _cli_main(cli, argv + (["--autotune"] if auto else []),
                             device)
        recording[0] = False
        _check_cli_run(p, f"{d}/out", rc, text)
        row = _row_of(p)
        return {"records": _records(row), "metrics": _metric_tree([row]),
                "row": row}

    def batch(syn, auto):
        if (syn, auto) not in cache:
            cache[syn, auto] = PB.run_pipeline_batch(
                f[syn, "series"], f"{os.path.dirname(f[syn, 'series'])}/out",
                device=dev, autotune=auto, save_artifacts=False)
        return cache[syn, auto]

    def all_runs():
        for auto in (False, True):
            for k in singles:
                t = twin_of(k)
                if t is not None and (t, auto) not in cache:
                    cache[t, auto] = one(t, auto)
                runs.append((k, auto, one(f[k], auto),
                             cache.get((t, auto))))
        for syn in series_syns:
            n = SERIES_N.get(syn, CLI_SERIES_N)
            for auto in (False, True):
                rc, text = _cli_main(cli, [
                    "--input", f[syn, "series"], "--output",
                    f"{os.path.dirname(f[syn, 'series'])}/out", "--batch",
                    "--no-show"] + (["--autotune"] if auto else []), dev)
                _require(rc == 0 and f"Frames processed: **{n}**" in text,
                         f"codecs --batch {syn} series: rc {rc}: "
                         f"{text[:300]}")
        return {(s_, auto): batch(s_, auto)
                for syn in series_syns for s_ in (twin_syn(syn), syn)
                for auto in (False, True)}

    calls: list = []
    with _recording(torch, kernels, calls, when=lambda: recording[0]):
        batches, paths[path] = _run_path(
            torch, kernels, f"{path}: cli on {'/'.join(single_syns)} files "
            "and their explicit-LE twins, deterministic and --autotune, "
            f"--batch on the {'/'.join(series_syns)} series", all_runs)
    for k in ("box_stats", "unsharp", "clahe", "wavelet_denoise"):
        _require(paths[path][k] > 0,
                 f"kernel {k} was not launched by the {path} CLI runs")
    for k, auto, got, want in runs:
        r = got["row"]
        label = f"{path} cli {k[0]} {k[1]}{' --autotune' if auto else ''}"
        hw = FILE_HW.get(k[1], CLI_SIZE * CLI_SIZE)
        for part in ("metrics_before", "metrics_after"):
            _require(all(np.isfinite(v) for v in (r[part] or {}).values()),
                     f"{label}: non-finite {part}")
        bit = lambda w: (r["metrics_before"]  # noqa: E731
                         == w["row"]["metrics_before"]
                         and r["metrics_after"] == w["row"]["metrics_after"])
        if k[0] == "j2k91" and not auto:
            cpu = one(f[k], False, "cpu")
            _against_twin(parity, label, got, cpu, hw, bit(cpu),
                          "its run on the CPU")
        if want is not None:
            _against_twin(parity, label, got, want, hw, bit(want))
    for syn in series_syns:
        n = SERIES_N.get(syn, CLI_SERIES_N)
        for auto in (False, True):
            g = batches[syn, auto]["frames"]
            w = batches[twin_syn(syn), auto]["frames"]
            rec = lambda fs: [(fr["issues"], fr["passed"])  # noqa: E731
                              for fr in fs]
            strip = lambda fs: [{k: v for k, v in fr.items()  # noqa: E731
                                 if k not in ("run_id", "source")}
                                for fr in fs]
            _against_twin(
                parity, f"{path} --batch {syn} series"
                f"{' --autotune' if auto else ''} ({len(g)} frames)",
                {"records": rec(g), "metrics": parity.flatten_batch(g)},
                {"records": rec(w), "metrics": parity.flatten_batch(w)},
                CLI_SIZE * CLI_SIZE, strip(g) == strip(w))
            _require(len(g) == n and all(
                np.isfinite(fr["metrics"]["sigma"]) for fr in g),
                f"codecs --batch {syn}: {len(g)} frames")
    _require(bool(calls), f"{path}: no kernel launched in the recorded "
             f"{recorded} run")
    check.replay(f"{path} cli {recorded[0]} {recorded[1]} {CLI_SIZE}^2 "
                 "deterministic", calls)
    check.require_ok()


def _dct_mixed(torch, kernels, parity, paths, dev, f: dict) -> None:
    """15.3: config 5's mixed directory with its 8 ultrasound files as the
    ``.4.50`` YBR 4:2:2 frame, ``main([... "--batch", "--window"])`` and
    ``run_pipeline_batch(window=True)`` (counters reset before, read after
    as ``paths["codecs_dct_mixed"]``) against the same directory with
    explicit-LE twins: every frame's issues, pass flag and metrics equal,
    bit for bit printed; B and 10 launched."""
    import numpy as np

    from mdx_torch import __main__ as cli
    from mdx_torch.pipeline import batch_runner as PB

    d, twin = f["dct_mixed", "dir"], f["dct_mixed_le", "dir"]
    n = MIXED_CT + MIXED_CXR + MIXED_US

    def runs():
        rc, text = _cli_main(cli, ["--input", d, "--output", f"{d}/out",
                                   "--batch", "--window", "--no-show"], dev)
        _require(rc == 0 and f"Frames processed: **{n}**" in text,
                 f"codecs --batch --window dct mixed: rc {rc}: {text[:300]}")
        return [PB.run_pipeline_batch(p, f"{p}/out", device=dev, window=True,
                                      save_artifacts=False)
                for p in (d, twin)]

    (got, want), paths["codecs_dct_mixed"] = _run_path(
        torch, kernels, f"codecs_dct_mixed: --batch --window on the mixed "
        f"directory with .4.50 ultrasound ({MIXED_CT} CT, {MIXED_CXR} CXR, "
        f"{MIXED_US} US) and its explicit-LE twin", runs)
    for k in ("box_stats", "wavelet_denoise"):
        _require(paths["codecs_dct_mixed"][k] > 0,
                 f"kernel {k} was not launched by the dct mixed directory")
    g, w = got["frames"], want["frames"]
    _require(len(g) == len(w) == n and [fr["source"] for fr in g] == [
        fr["source"] for fr in w], f"codecs dct mixed: {len(g)} frames")
    strip = lambda fs: [{k: v for k, v in fr.items()  # noqa: E731
                         if k not in ("run_id", "source")} for fr in fs]
    rec = lambda fs: [(fr["issues"], fr["passed"]) for fr in fs]  # noqa: E731
    for fr in g:
        _require(np.isfinite(fr["metrics"]["sigma"]),
                 f"codecs dct mixed: non-finite sigma in {fr['source']}")
    _against_twin(parity, f"codecs_dct_mixed --batch --window ({n} frames, "
                  f"buckets {sorted({tuple(fr['shape']) for fr in g})})",
                  {"records": rec(g), "metrics": parity.flatten_batch(g)},
                  {"records": rec(w), "metrics": parity.flatten_batch(w)},
                  CLI_SIZE * CLI_SIZE, strip(g) == strip(w),
                  "the directory of explicit-LE twins")


def _codec_spatial(kernels, parity, check, paths, card, dev, f: dict) -> None:
    """15.3: ``--spatial`` on the ``.4.70`` and ``.4.90`` chest X-rays at
    k = 1 against the explicit-LE file's run: issues and ops equal, metrics
    within ``parity.breaches``."""
    import os

    import numpy as np

    from mdx_torch.core.metrics import METRIC_KEYS
    from mdx_torch.tools import cli_latency as CL

    ctxs = {}
    for syn in ("ll", "j2k", "le"):
        p = f[syn, "cxr"]
        out = f"{os.path.dirname(p)}/out"
        run, ctx = _spatial_cli_run(
            kernels, parity, check, paths, f"codecs cxr {syn} k1",
            lambda p=p, out=out: CL.spatial_cli(p, out, dev))
        _check_spatial_cli(run, p, out, f"codecs --spatial {syn} cxr")
        _print_spatial_times(f"codecs --spatial {syn} cxr [1,{BIG},{BIG}]",
                             run, card)
        ctxs[syn] = ctx
    tree = lambda c: {"stats": {k: np.float32([c["metrics"][k]])  # noqa: E731
                                for k in METRIC_KEYS},
                      "metrics_after": {k: np.float32([c["metrics_after"][k]])
                                        for k in METRIC_KEYS}}
    rec = lambda c: (c["issues"], c["applied_ops"],  # noqa: E731
                     c["noise_amp_guard"])
    b = ctxs["le"]
    for syn, uid in (("ll", ".4.70"), ("j2k", ".4.90")):
        a = ctxs[syn]
        _against_twin(parity, f"codecs --spatial {uid} cxr k = 1",
                      {"records": rec(a), "metrics": tree(a)},
                      {"records": rec(b), "metrics": tree(b)}, BIG * BIG,
                      bool(np.array_equal(a["enhanced"], b["enhanced"])))


def _codec_times(card: str, dev, f: dict) -> None:
    """15.4: ms per frame to decode and encode (host loops at 512^2 and
    2048^2; Python loops at 512^2, JPEG 2000's at 128^2 beside its host
    loops there), frames/s of the series in the four syntaxes in turns, and
    the warm ``run_pipeline`` by phase; each beside the card and the host's
    CPU."""
    import os
    import tempfile

    from mdx_torch.io.dicom import decode_pixels, read_dataset
    from mdx_torch.tools import cli_latency as CL
    from mdx_torch.tools import time_codecs as TC

    host = TC.host_line()
    pix = lambda p: decode_pixels(read_dataset(p))  # noqa: E731
    for label, frame, py in ((f"[{CLI_SIZE},{CLI_SIZE}] noisy",
                              pix(f["le", "noisy"]), True),
                             (f"[{BIG},{BIG}] cxr", pix(f["le", "cxr"]),
                              False)):
        t = TC.frame_times(frame, 5)
        print(f"codec ms a frame {label}, host loops (median of 5) on host "
              f"{host} beside {card}: {t}")
        t = TC.j2k_decode_split(frame, 5)
        print(f"codec jpeg2k decode {label} split (median ms of 5) on host "
              f"{host} beside {card}: {t}")
        if py:
            t = TC.frame_times(frame, 1, python=True,
                               families=TC.FAMILIES[:2])
            print(f"codec ms a frame {label}, Python loops (one call) on host "
                  f"{host} beside {card}: {t}")
    corner = pix(f["le", "noisy"])[:J2K_PY_SIZE, :J2K_PY_SIZE]
    for loops, reps, py in (("host loops (median of 5)", 5, False),
                            ("Python loops (one call)", 1, True)):
        t = TC.frame_times(corner, reps, python=py, families=("jpeg2k",))
        print(f"codec ms a frame [{J2K_PY_SIZE},{J2K_PY_SIZE}] noisy corner, "
              f"{loops} on host {host} beside {card}: {t}")
    for name, t in TC.dct_decode_split_all(5).items():
        print(f"codec jpegdct decode {name} split, host loops (median ms of "
              f"5) on host {host} beside {card}: {t}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tc_") as tmp:
        t = TC.transcode_times(tmp, {"512": pix(f["le", "noisy"]),
                                     "2048": pix(f["le", "cxr"])}, 3)
    print(f"codec transcode ms (median of 3) on host {host} beside {card}: "
          f"{t}")
    fps = {}
    for syn in ("le",) + CODEC_SYNTAXES:
        p = f[syn, "series"]
        fps[syn] = CL.batch_fps(p, f"{os.path.dirname(p)}/out", dev,
                                reps=CODEC_SERIES_REPS)
    for syn, r in fps.items():
        print(f"codecs batch series [{CLI_SERIES_N},{CLI_SIZE},{CLI_SIZE}] "
              f"{syn} on {card}, host {host}: {r['frames_per_s']!r} frames/s "
              f"(median {r['median_ms']!r} ms of {CODEC_SERIES_REPS}, runs "
              f"{r['runs_ms']})")
    warm = [(syn, name) for syn in ("le",) + CODEC_SYNTAXES
            for name in ("noisy", "cxr")]
    warm += [(syn, name) for name in ("ct_rst", "us")
             for syn in ("dct", "dct_le")]
    for syn, name in warm:
        p = f[syn, name]
        w = CL.warm_runs(p, f"{os.path.dirname(p)}/out", 5, dev)
        phases = ", ".join(f"{k} {v!r}" for k, v in w["phases_ms"].items())
        print(f"codecs warm run_pipeline {syn} {name} on {card}, host "
              f"{host}: median {w['median_ms']!r} ms of 5; phases "
              f"(median ms): {phases}")


def _phase_codecs(torch, kernels, parity, check, paths: dict, card: str,
                  dev) -> None:
    """Phase 15: the lossless JPEG and JPEG 2000 codecs (module doc), their
    files and DB in a temporary directory."""
    import os
    import tempfile

    from mdx_torch.io import native

    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    # 15.1 the host library, built from the checkout's source at first use
    t0 = time.perf_counter()
    native.load()
    print(f"codecs host library: {native.BUILD} (load "
          f"{time.perf_counter() - t0:.2f} s)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as tmp:
        os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
        os.environ.pop("MDX_TV_MODE", None)
        f, blurred = _codec_inputs(tmp)
        _dct_inputs(tmp, f)
        print(f"codecs inputs written: {time.perf_counter() - t15:.1f} s")
        _codec_pixels(native, f, blurred)
        cache: dict = {}
        for path, singles, series, recorded in CODEC_PATHS:
            _codec_cli(torch, kernels, parity, check, paths, dev, f, path,
                       singles, series, recorded, cache)
        _dct_mixed(torch, kernels, parity, paths, dev, f)
        _codec_spatial(kernels, parity, check, paths, card, dev, f)
        _codec_transcodes(f)
        print(f"phase 15 checks: {time.perf_counter() - t15:.1f} s")
        _codec_times(card, dev, f)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")


# phase 16: the JSON API on the card (mdx_torch/serve), phase 12's four
# 512^2 files; the blurred slice runs B, U, C and 10 (CLAHE, unsharp, the
# light and corrective wavelet denoises)
SERVE_START_S = 120
SERVE_RUN_S = 300
SERVE_WARM = 3


def _http(port: int, method: str, path: str, body: bytes = b"",
          ctype: str = "application/json") -> tuple[int, dict, bytes]:
    """One request to the server on this machine's ``port``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body or None,
                     headers={"Content-Type": ctype} if body else {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _http_json(port: int, method: str, path: str, data=None):
    s, _, body = _http(port, method, path,
                       json.dumps(data).encode() if data is not None else b"")
    return s, json.loads(body)


def _serve_upload(port: int, path: str) -> dict:
    """``POST /api/upload`` of the file at ``path`` (multipart field
    ``file``) → the JSON body."""
    import os

    boundary = "chipsmokeboundary16"
    with open(path, "rb") as fh:
        content = fh.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{os.path.basename(path)}\"\r\nContent-Type: "
            f"application/octet-stream\r\n\r\n").encode() + content + (
        f"\r\n--{boundary}--\r\n").encode()
    s, _, out = _http(port, "POST", "/api/upload", body,
                      f"multipart/form-data; boundary={boundary}")
    _require(s == 200, f"serve upload {path}: {s} {out[:300]!r}")
    return json.loads(out)


def _serve_post_run(port: int, file_id: str, **flags) -> tuple[str, float]:
    """``POST /api/run`` → (run id, the request's start on the host clock)."""
    t0 = time.perf_counter()
    s, run = _http_json(port, "POST", "/api/run", {"file_id": file_id,
                                                   **flags})
    _require(s == 202 and run["status"] == "pending", f"serve run: {s} {run}")
    return run["run_id"], t0


def _serve_poll(port: int, run_id: str, t0: float) -> float:
    """Polls the run's status until it completes → ms from ``t0`` to the
    answer that said so; fails on ``error`` or after ``SERVE_RUN_S``."""
    while True:
        s, st = _http_json(port, "GET", f"/api/runs/{run_id}/status")
        _require(s == 200, f"serve status {run_id}: {s} {st}")
        if st["status"] == "completed":
            return (time.perf_counter() - t0) * 1e3
        if st["status"] == "error":
            from mdx_torch.pipeline import storage

            raise SmokeFailure(f"serve run {run_id} ended in error: "
                               f"{storage.get_run_status(run_id)}")
        _require(time.perf_counter() - t0 < SERVE_RUN_S,
                 f"serve run {run_id}: not completed in {SERVE_RUN_S} s")
        time.sleep(0.005)


def _serve_posted(port: int, file_id: str, **flags) -> tuple[str, float]:
    """Run and poll one uploaded file → (run id, request-to-completed ms)."""
    run_id, t0 = _serve_post_run(port, file_id, **flags)
    return run_id, _serve_poll(port, run_id, t0)


def _serve_run(port: int, path: str, **flags) -> tuple[str, float]:
    """Upload, run and poll one file → (run id, request-to-completed ms)."""
    return _serve_posted(port, _serve_upload(port, path)["file_id"], **flags)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_subprocess(tmp: str, f: dict, card: str) -> None:
    """16.1: ``python -m mdx_torch.serve.api`` as users start it, on a free
    ``PORT``: the seconds to its first answer, one cold run, then stopped."""
    import os
    import subprocess

    port = _free_port()
    env = dict(os.environ, PORT=str(port))
    log = open(f"{tmp}/serve_api.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mdx_torch.serve.api"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            _require(proc.poll() is None,
                     f"serve subprocess exited {proc.returncode}: "
                     f"{open(log.name).read()[-2000:]}")
            try:
                s, index = _http_json(port, "GET", "/")
                break
            except OSError:
                _require(time.perf_counter() - t0 < SERVE_START_S,
                         f"serve subprocess: no answer in {SERVE_START_S} "
                         f"s: {open(log.name).read()[-2000:]}")
                time.sleep(0.1)
        start_s = time.perf_counter() - t0
        _require(s == 200 and "mdx_torch" in index["name"],
                 f"serve subprocess GET /: {s} {index}")
        run_id, cold_ms = _serve_run(port, f["blurred"])
        s, detail = _http_json(port, "GET", f"/api/runs/{run_id}")
        _require(s == 200 and detail["issues"],
                 f"serve subprocess detail: {s}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    print(f"serve subprocess python -m mdx_torch.serve.api on {card}: start "
          f"to first answer {start_s!r} s, cold run (blurred {CLI_SIZE}^2) "
          f"request to completed {cold_ms!r} ms; stopped (rc "
          f"{proc.returncode})")


def _same_rows(label: str, parity, got_id: str, want_id: str) -> None:
    from mdx_torch.pipeline import storage

    diff = parity.row_differences(storage.get_run(got_id),
                                  storage.get_run(want_id))
    _require(not diff, f"serve {label}: row differs from run_pipeline's: "
             f"{diff}")


def _phase_serve(torch, kernels, parity, check, paths: dict, card: str,
                 dev) -> None:
    """Phase 16: the JSON API on the card (module doc), its uploads,
    outputs and DB in a temporary directory."""
    import os
    import tempfile

    t16 = time.perf_counter()
    keys = ("MDX_DB_PATH", "UPLOAD_DIR", "OUTPUT_DIR", "OPENAI_API_KEY")
    saved = {k: os.environ.get(k) for k in keys}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
            os.environ.update(MDX_DB_PATH=f"{tmp}/runs.db",
                              UPLOAD_DIR=f"{tmp}/uploads",
                              OUTPUT_DIR=f"{tmp}/outputs")
            # the chat answers from the stored data; no model is called
            os.environ.pop("OPENAI_API_KEY", None)
            f = _cli_singles(tmp)
            _serve_subprocess(tmp, f, card)
            _serve_in_process(torch, kernels, parity, check, paths, card,
                              dev, tmp, f)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")


def _serve_in_process(torch, kernels, parity, check, paths, card, dev, tmp,
                      f) -> None:
    import importlib
    import os
    import threading

    import numpy as np

    from mdx_torch.io.visuals import read_png
    from mdx_torch.pipeline import storage
    from mdx_torch.pipeline.runner import run_pipeline
    from mdx_torch.serve import api, config

    importlib.reload(config)
    app = api.create_app(device=dev)
    server = app.make_server("127.0.0.1", 0)
    port = server.server_port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    serial = f"{tmp}/serial"
    uploaded = lambda run_id: os.path.join(  # noqa: E731
        config.UPLOAD_DIR, storage.get_run(run_id)["input_filename"])
    try:
        # 16.2 one run through the server, its kernel calls recorded
        up = _serve_upload(port, f["blurred"])
        calls: list = []
        with _recording(torch, kernels, calls):
            (run_id, ms), paths["serve_512"] = _run_path(
                torch, kernels, f"serve run [1,{CLI_SIZE},{CLI_SIZE}] "
                "blurred", lambda: _serve_posted(port, up["file_id"]))
        for k in ("box_stats", "unsharp", "clahe", "wavelet_denoise",
                  "select"):
            _require(paths["serve_512"][k] > 0,
                     f"kernel {k} was not launched by the served run")
        check.replay(f"serve {CLI_SIZE}^2 blurred", calls)
        del calls
        check.require_ok()
        got = {}
        for route in ("", "/report", "/logs", "/before_after"):
            s, headers, body = _http(port, "GET", f"/api/runs/{run_id}{route}")
            _require(s == 200, f"serve GET /api/runs/<id>{route}: {s}")
            got[route] = (headers, body)
        detail = json.loads(got[""][1])
        _require(detail["status"] == "completed" and detail["issues"]
                 and json.loads(got["/report"][1])["markdown"].startswith("# "),
                 f"serve detail / report: {detail['status']}")
        want = run_pipeline(uploaded(run_id), serial, device=dev)
        _same_rows("blurred", parity, run_id, want["run_id"])
        png_path = f"{tmp}/served.png"
        with open(png_path, "wb") as fh:
            fh.write(got["/before_after"][1])
        served, direct = read_png(png_path), read_png(
            want["visuals"]["before_after"])
        _require(got["/before_after"][0].get("Content-Type") == "image/png"
                 and served.shape == direct.shape
                 and np.array_equal(served, direct),
                 "serve: the before/after PNG differs from run_pipeline's")
        s, chat = _http_json(port, "POST", f"/api/runs/{run_id}/chat",
                             {"message": "What did this run change?"})
        _require(s == 200 and "stored-data summary" in chat["reply"],
                 f"serve chat: {s} {chat}")
        s, hist = _http_json(port, "GET", f"/api/runs/{run_id}")
        _require([m["role"] for m in hist["chat_history"]] == [
            "user", "assistant"], f"serve chat history: {hist}")
        print(f"serve run blurred: row equal to run_pipeline's, PNG "
              f"{served.shape} bit-equal, issues {detail['issues']}, chat "
              f"200 ({chat['reply'][:60]!r}...)")
        warm = [_serve_run(port, f["blurred"])[1] for _ in range(SERVE_WARM)]
        print(f"serve in-process run blurred {CLI_SIZE}^2 on {card}: first "
              f"request to completed {ms!r} ms, warm {warm} ms (median "
              f"{statistics.median(warm)!r})")

        # 16.3 four runs posted back to back: the four workers at once
        ups = [_serve_upload(port, f[k]) for k in CLI_KINDS]
        posted = {}

        def four():
            t0 = time.perf_counter()
            for k, u in zip(CLI_KINDS, ups):
                posted[k] = _serve_post_run(port, u["file_id"])[0]
            for rid in posted.values():
                _serve_poll(port, rid, t0)
            return (time.perf_counter() - t0) * 1e3

        wall, paths["serve_concurrent"] = _run_path(
            torch, kernels, f"serve 4 concurrent runs [1,{CLI_SIZE},"
            f"{CLI_SIZE}]", four)
        for k in ("box_stats", "unsharp", "clahe", "wavelet_denoise",
                  "select"):
            _require(paths["serve_concurrent"][k] > 0,
                     f"kernel {k} was not launched by the concurrent runs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial_ids = {k: run_pipeline(uploaded(posted[k]), serial,
                                      device=dev)["run_id"]
                      for k in CLI_KINDS}
        torch.cuda.synchronize()
        serial_ms = (time.perf_counter() - t0) * 1e3
        for k in CLI_KINDS:
            _same_rows(f"concurrent {k}", parity, posted[k], serial_ids[k])
        print(f"serve 4 concurrent runs ({', '.join(CLI_KINDS)}) on {card}: "
              f"{wall!r} ms from the first request to the last completed, "
              f"against {serial_ms!r} ms for 4 serial run_pipeline calls; "
              f"each row equal to its serial row")

        # 16.4 genai, and genai with autotune, as JAX's server runs them
        up = _serve_upload(port, f["blurred"])

        def flags():
            out = {}
            for label, body in (("genai", {"genai": True}),
                                ("genai_autotune", {"genai": True,
                                                    "autotune": True})):
                out[label] = _serve_posted(port, up["file_id"], **body)
            return out

        runs, paths["serve_genai"] = _run_path(
            torch, kernels, "serve genai and genai + autotune", flags)
        _same_rows("genai", parity, runs["genai"][0], want["run_id"])
        tuned = run_pipeline(uploaded(runs["genai_autotune"][0]), serial,
                             device=dev, autotune=True)
        _same_rows("genai + autotune", parity, runs["genai_autotune"][0],
                   tuned["run_id"])
        _require(storage.get_run(runs["genai_autotune"][0])["genai_model"]
                 == "on-device autotune", "serve genai + autotune: no sweep")
        print(f"serve genai: completed in {runs['genai'][1]!r} ms, row equal "
              f"to the deterministic run's; genai + autotune: completed in "
              f"{runs['genai_autotune'][1]!r} ms, row equal to "
              f"run_pipeline(autotune=True)'s")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


# phase 17: GenAI mode on the card with a scripted model (no key, no
# network: the transport seam of mdx_torch.genai.client).  The tuning agent
# applies two plans, validates and scores both, and ends with GENAI_FINAL,
# whose chain runs B, U, C, 10, 5 (d = 5) and T.
GENAI_ITERS = 2
GENAI_KERNELS = ("box_stats", "unsharp", "clahe", "wavelet_denoise",
                 "bilateral", "tv_chambolle")
GENAI_LLM_CALLS = 9
GENAI_REPS = 5
GENAI_PHASES = ("planner", "tuning", "execute", "explainability")


def _genai_plan(ops, **params) -> str:
    return json.dumps({"recommended_ops": list(ops), "params": params,
                       "risk_warnings": [],
                       "rationale": "Scripted plan of the smoke run.",
                       "safety": "", "stop_reason": None})


GENAI_SEED = _genai_plan(("denoise", "clahe", "unsharp"),
                         clahe_clip_limit=0.02, unsharp_amount=0.5)
GENAI_FIRST = _genai_plan(("denoise", "clahe", "unsharp"),
                          clahe_clip_limit=0.03, unsharp_radius=1.2,
                          unsharp_amount=0.7)
GENAI_FINAL = _genai_plan(
    ("denoise", "clahe", "unsharp", "bilateral", "tv_denoise"),
    clahe_clip_limit=0.02, unsharp_radius=1.0, unsharp_amount=0.6,
    bilateral_d=5, bilateral_sigma_color=0.05, bilateral_sigma_space=0.05,
    tv_denoise_weight=0.05)
GENAI_EXPLANATION = json.dumps({
    "detected_issues": "Scripted explanation of the smoke run.",
    "corrective_measures": "Denoise, CLAHE, unsharp, bilateral and TV.",
    "enhancement_applied": "The tuned plan.",
    "validation_outcome": "See the validation block.",
    "limitations": "Not for clinical diagnosis.",
    "image_summary": "A synthetic slice.",
    "actionable_suggestions": ["Review the before/after panel."],
    "next_steps": ["Archive the run record."]})


class GenAIScript:
    """The scripted model of phase 17: the planner's seed plan; two rounds
    of apply, validate and score (GENAI_FIRST, then GENAI_FINAL); the final
    plan; the explanation.  A step that names an enhanced image reads its
    id from the tool results it is sent."""

    def __init__(self, llm):
        self.llm, self.requests = llm, 0
        self.steps = [self._text(GENAI_SEED)]
        for plan in (GENAI_FIRST, GENAI_FINAL):
            self.steps += [
                lambda m, p=plan: self._call("tool_apply_enhancement",
                                             image_id="original",
                                             plan_json=p),
                lambda m: self._call(
                    "tool_validate", original_id="original",
                    enhanced_id=self._outputs(m)[-1]["enhanced_image_id"]),
                lambda m: self._call(
                    "tool_score_plan",
                    validation_json=json.dumps(self._outputs(m)[-1]))]
        self.steps += [self._text(GENAI_FINAL),
                       self._text(GENAI_EXPLANATION)]

    @staticmethod
    def _text(content):
        return lambda m: {"choices": [{"message": {"content": content,
                                                   "tool_calls": []}}]}

    @staticmethod
    def _call(name, **args):
        return {"choices": [{"message": {"content": None, "tool_calls": [
            {"id": name, "function": {"name": name,
                                      "arguments": json.dumps(args)}}]}}]}

    @staticmethod
    def _outputs(messages):
        return [json.loads(m["content"]) for m in messages
                if m.get("role") == "tool"]

    def __call__(self, model, payload):
        self.requests += 1
        if not self.steps:
            raise self.llm.LLMError("script exhausted")
        return self.steps.pop(0)(payload["messages"])


def _genai_run(path: str, out: str, dev, **kw) -> dict:
    """``run_pipeline(genai=True)`` on ``dev`` with the scripted model."""
    from mdx_torch.genai import client as llm
    from mdx_torch.pipeline.runner import run_pipeline

    script = GenAIScript(llm)
    llm.set_transport(script)
    try:
        ctx = run_pipeline(path, out, genai=True, model="gpt-5-mini",
                           max_iters=GENAI_ITERS, device=dev, **kw)
    finally:
        llm.set_transport(None)
    ctx["script_requests"] = script.requests
    return ctx


def _check_genai(label: str, ctx: dict, hw: int) -> None:
    """A scripted GenAI run that did not fall back: every call of the
    script made, two scored iterations and one chosen, the final plan's
    ops applied, its image finite, its report on disk and its DB row."""
    import numpy as np

    from mdx_torch.pipeline import storage

    _require(not ctx.get("genai_fell_back"),
             f"genai {label}: fell back ({ctx.get('genai_error')})")
    its = ctx["genai_iterations"]
    _require(ctx["script_requests"] == GENAI_LLM_CALLS
             and ctx["genai_llm_calls"] == GENAI_LLM_CALLS,
             f"genai {label}: {ctx['genai_llm_calls']} LLM calls")
    _require(len(its) == 2 and sum(r.chosen for r in its) == 1
             and all(r.score != 0.0 for r in its),
             f"genai {label}: iterations {[(r.score, r.chosen) for r in its]}")
    _require(ctx["applied_ops"][:5] == ["denoise", "clahe", "unsharp",
                                        "bilateral", "tv_denoise"],
             f"genai {label}: applied {ctx['applied_ops']}")
    img = np.asarray(ctx["enhanced_image"])
    _require(img.shape == (hw, hw) and bool(np.isfinite(img).all()),
             f"genai {label}: enhanced {img.shape}")
    with open(ctx["report_path"], encoding="utf-8") as fh:
        report = fh.read()
    _require("## 🤖 GenAI Plan (JSON)" in report
             and "## 🧠 Explainability (GenAI)" in report,
             f"genai {label}: report lacks the GenAI sections")
    row = storage.get_run(ctx["run_id"])
    _require(row is not None and row["genai_model"] == "gpt-5-mini"
             and row["genai_llm_calls"] == GENAI_LLM_CALLS
             and json.loads(row["plan_json"]) == json.loads(
                 ctx["genai_plan"].model_dump_json()),
             f"genai {label}: DB row")


def _genai_walls(ctx: dict) -> dict:
    """Seconds from each GenAI phase's start to its end in the trace."""
    start, walls = {}, {}
    for e in ctx["agent_traces"]:
        if e["event"] == "phase_start":
            start[e["phase"]] = e["timestamp"]
        elif e["event"] == "phase_end" and e["phase"] in start:
            walls[e["phase"]] = e["timestamp"] - start[e["phase"]]
    return {p: walls.get(p) for p in GENAI_PHASES}


def _genai_against_cpu(parity, label: str, card_ctx: dict, cpu_ctx: dict,
                       hw: int) -> None:
    """The card's run against the CPU's: every field within
    ``parity.breaches`` with TV's allowance (the plan ran tv_denoise), the
    iteration records' plans, the chosen record and the applied ops equal,
    the scores within ``parity.SCORE_ATOL``.  The two metrics that one ulp
    of an enhanced image moves (``parity.ILL_CONDITIONED_AFTER``) are
    printed, not required, once the images agree within TV's
    allowance."""
    g, w = parity.flatten_run(card_ctx), parity.flatten_run(cpu_ctx)
    bad = parity.breaches(g, w, tv_ran=True, hw=hw * hw)
    images_agree = not parity.breaches(g, w, ["enhanced"], tv_ran=True)
    soft = [b for b in bad if images_agree
            and b.split(":", 1)[0] in parity.ILL_CONDITIONED_AFTER]
    bad = [b for b in bad if b not in soft]
    dump = lambda its: [(r.plan.model_dump_json(), r.chosen)  # noqa: E731
                        for r in its]
    if dump(card_ctx["genai_iterations"]) != dump(cpu_ctx["genai_iterations"]):
        bad.append("iteration plans or the chosen record differ")
    for a, b in zip(card_ctx["genai_iterations"], cpu_ctx["genai_iterations"]):
        if abs(a.score - b.score) > parity.SCORE_ATOL:
            bad.append(f"iteration {a.iteration} score {a.score!r} vs "
                       f"{b.score!r}")
    if card_ctx["applied_ops"] != cpu_ctx["applied_ops"]:
        bad.append(f"applied_ops {card_ctx['applied_ops']} vs "
                   f"{cpu_ctx['applied_ops']}")
    if (card_ctx["genai_plan"].model_dump_json()
            != cpu_ctx["genai_plan"].model_dump_json()):
        bad.append("best plan differs")
    print(f"genai {label} card vs cpu: enhanced max|d| "
          f"{parity.max_abs(g, w, 'enhanced')!r}, scores card "
          f"{[r.score for r in card_ctx['genai_iterations']]} cpu "
          f"{[r.score for r in cpu_ctx['genai_iterations']]}, breaches "
          f"{len(bad)}, printed {len(soft)}")
    for line in bad + soft:
        print("  " + line)
    _require(not bad, f"genai {label}: card and CPU disagree")


def _phase_genai(torch, kernels, parity, check, paths: dict, card: str,
                 dev) -> None:
    """Phase 17: GenAI mode on the card (module doc), its files and DB in a
    temporary directory, no ``OPENAI_API_KEY``."""
    import os
    import subprocess
    import tempfile

    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    keys = ("MDX_DB_PATH", "OPENAI_API_KEY", "MDX_TV_MODE")
    saved = {k: os.environ.get(k) for k in keys}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_genai_") as tmp:
            os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
            os.environ.pop("OPENAI_API_KEY", None)
            os.environ.pop("MDX_TV_MODE", None)
            f = _genai_inputs(tmp)
            # 17.a the scripted run at 512^2 and 2048^2, recorded
            for size, key in ((CLI_SIZE, "noisy"), (BIG, "cxr")):
                label = f"genai_{size}"
                calls: list = []
                with _recording(torch, kernels, calls):
                    ctx, paths[label] = _run_path(
                        torch, kernels, f"genai run [1,{size},{size}] "
                        f"{key}", lambda: _genai_run(f[key], f"{tmp}/out",
                                                     dev))
                for k in GENAI_KERNELS:
                    _require(paths[label][k] > 0,
                             f"kernel {k} was not launched by the GenAI run "
                             f"at {size}^2")
                _check_genai(label, ctx, size)
                check.replay(f"genai {size}^2", calls)
                del calls
                check.require_ok()
                walls = _genai_walls(ctx)
                print(f"genai {size}^2 on {card}: phases (s) {walls}, run "
                      f"phase_ms {ctx['phase_ms']}, iterations "
                      f"{[(r.score, r.chosen) for r in ctx['genai_iterations']]}"
                      f", applied {ctx['applied_ops']}")
                t0 = time.perf_counter()
                cpu_ctx = _genai_run(f[key], f"{tmp}/out_cpu", "cpu")
                print(f"genai {size}^2 on the CPU: "
                      f"{time.perf_counter() - t0:.1f} s")
                _check_genai(f"{label} cpu", cpu_ctx, size)
                _genai_against_cpu(parity, f"{size}^2", ctx, cpu_ctx, size)
                del ctx, cpu_ctx
            # 17.b plan only
            plan, paths["genai_plan_only"] = _run_path(
                torch, kernels, f"genai plan only [1,{CLI_SIZE},{CLI_SIZE}]",
                lambda: _genai_run(f["noisy"], f"{tmp}/out", dev,
                                   plan_only=True))
            _require(plan.get("plan_only") and json.loads(
                plan["plan"].model_dump_json()) == json.loads(
                    _genai_plan_dump(GENAI_SEED)),
                f"genai plan only: {plan}")
            print("genai plan only: the planner's plan, nothing executed")
            # 17.c the CLI without a key and without a transport
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "mdx_torch", "--input", f["noisy"],
                 "--output", f"{tmp}/cli", "--genai", "--max-iters",
                 str(GENAI_ITERS)], capture_output=True, text=True,
                timeout=600, env=dict(os.environ, MDX_DB_PATH=f"{tmp}/cli.db"))
            warning = ("WARNING: GenAI failed (planner failed: OPENAI_API_KEY "
                       "not set; fallback: OPENAI_API_KEY not set). Used "
                       "deterministic fallback.")
            _require(r.returncode == 0 and r.stdout.startswith("# ")
                     and r.stdout.rstrip().endswith(warning),
                     f"genai CLI without a key: rc {r.returncode}: "
                     f"{r.stdout[-300:]} {r.stderr[-1500:]}")
            print(f"genai CLI without a key: rc 0, the deterministic report "
                  f"and main.py's warning ({time.perf_counter() - t0:.1f} s)")
            _genai_tool_times(torch, f, card, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")


def _genai_plan_dump(text: str) -> str:
    from mdx_torch.core.schemas import EnhancementPlan

    return EnhancementPlan.model_validate_json(text).model_dump_json()


def _genai_inputs(root) -> dict:
    """Phase 12's noisy 512^2 slice (config 1) and 2048^2 chest X-ray."""
    from mdx_torch.io import write_synthetic_dicom

    return {"noisy": write_synthetic_dicom(f"{root}/noisy.dcm", kind="noisy",
                                           size=CLI_SIZE, seed=20),
            "cxr": _write_cxr(root)}


def _genai_tool_times(torch, f: dict, card: str, dev) -> None:
    """Median ms of ``tool_apply_enhancement`` (GENAI_FINAL) and of
    ``tool_validate`` on the card at 512^2 and 2048^2."""
    from mdx_torch.genai import tools as T
    from mdx_torch.io import load_dicom, normalize_image

    saved = T.get_context()
    T.set_context(dev)
    try:
        for size, key in ((CLI_SIZE, "noisy"), (BIG, "cxr")):
            T.register_image(normalize_image(load_dicom(f[key])[0]),
                             "original")
            enh = json.loads(T.tool_apply_enhancement(
                "original", GENAI_FINAL))["enhanced_image_id"]
            apply_ms, a = _median_ms(torch, lambda: T.tool_apply_enhancement(
                "original", GENAI_FINAL), GENAI_REPS)
            val_ms, v = _median_ms(torch, lambda: T.tool_validate(
                "original", enh), GENAI_REPS)
            print(f"genai tools [1,{size},{size}] on {card}: "
                  f"tool_apply_enhancement (the final plan) median "
                  f"{apply_ms!r} ms (min {min(a)!r}), tool_validate median "
                  f"{val_ms!r} ms (min {min(v)!r}), {GENAI_REPS} reps")
            T.clear_image_store()
    finally:
        T.clear_image_store()
        T.set_context(*saved)


# phase 18: deploy-time priming (mdx_torch/pipeline/prime.py)
PRIME_SIZE, PRIME_SPATIAL_SIZE = 512, 2048
# JAX's count at the defaults, one shape each: the single pass + 3 stored
# integer dtypes x 2 window modes + float32 unwindowed; K = 9 and 27 + the
# three GenAI tool functions; the stats pass + the 7 distinct gate sets of
# SPATIAL_ISSUE_SETS at 2048^2 on one rank + one sweep
PRIME_COUNTS = {"prime": 8, "prime_tuning": 5, "prime_spatial": 9}
PRIME_KERNELS = ("box_stats", "unsharp", "clahe", "wavelet_denoise",
                 "clahe_remap_ext")


def _build_files(root: str) -> dict:
    """{path under ``root``/build: (size, mtime_ns)} of every file."""
    import os

    out = {}
    base = os.path.join(root, "build")
    for d, _, names in os.walk(base):
        for n in names:
            st = os.stat(os.path.join(d, n))
            out[os.path.relpath(os.path.join(d, n), base)] = (
                st.st_size, st.st_mtime_ns)
    return out


def _package_copy(dst: str) -> str:
    """``mdx_torch/`` copied into the empty directory ``dst`` (no
    ``build/``, no bytecode) → ``dst``."""
    import os
    import shutil

    import mdx_torch

    shutil.copytree(os.path.dirname(os.path.abspath(mdx_torch.__file__)),
                    os.path.join(dst, "mdx_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _fresh(cmd: list, cwd: str, env: dict) -> tuple:
    """``python <cmd>`` in a new process from ``cwd`` → (rc, stdout,
    stderr, wall s)."""
    import subprocess

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def _prime_in_process(torch, kernels, parity, check, paths: dict,
                      card: str) -> None:
    """18.a: ``prime``, ``prime_tuning`` and ``prime_spatial`` at their
    default arguments in this process (the spatial one launches its ranks),
    counters reset before and read after; JAX's counts, B, U, C, 10 and 11
    launched, every recorded call replayed."""
    from mdx_torch.pipeline import prime as PR
    from mdx_torch.tools import spatial_check as SC

    steps: list[str] = []
    calls: list = []
    with _recording(torch, kernels, calls), _recorded_launches() as launched:
        counts, in_process = _run_path(
            torch, kernels, f"prime [{PRIME_SIZE}^2], prime_tuning "
            f"[{PRIME_SIZE}^2] and prime_spatial [{PRIME_SPATIAL_SIZE}^2]",
            lambda: {
                "prime": PR.prime([(PRIME_SIZE, PRIME_SIZE)],
                                  log=steps.append),
                "prime_tuning": PR.prime_tuning(
                    [(PRIME_SIZE, PRIME_SIZE)], log=steps.append),
                "prime_spatial": PR.prime_spatial(
                    [(PRIME_SPATIAL_SIZE, PRIME_SPATIAL_SIZE)],
                    log=steps.append)})
    for line in steps:
        print(f"prime on {card}: {line}")
    _require(counts == PRIME_COUNTS,
             f"prime counts {counts}, JAX's formula {PRIME_COUNTS}")
    _require(len(launched) == 1,
             f"prime_spatial made {len(launched)} launches, not one")
    res, smoke = launched[0]
    per_rank = [sm["launches"] for sm in smoke]
    print(f"launches in prime_spatial ({res.backend}, {len(smoke)} ranks), "
          f"per rank: {per_rank}")
    paths["prime"] = {k: in_process[k] + sum(int(lr[k]) for lr in per_rank)
                      for k in kernels.LAUNCHES}
    print(f"launches on the prime path: {paths['prime']}")
    for k in PRIME_KERNELS:
        _require(paths["prime"][k] > 0,
                 f"kernel {k} was not launched by the prime path")
    check.replay("prime path", calls)
    del calls
    for name in ("clahe_luts", "clahe_remap_ext"):
        n_calls, err, ok = smoke[0]["replay"][name]
        row = SC.ROW_OF.get(name, name)
        print(f"replayed rank 0 prime_spatial {name}: {int(n_calls)} calls, "
              f"max|d| {float(err)!r} (tol {parity_tol(row)})")
        check.errs[row] = max(check.errs[row], float(err))
        _require(bool(ok) and int(n_calls) > 0,
                 f"{name} replay prime_spatial: max|d| {float(err)!r}")
    check.require_ok()


def _prime_deploy(card: str, tmp: str) -> None:
    """18.b-c: the deploy story on copies of ``mdx_torch/`` with empty
    ``build/`` directories: the primer's CLI builds both libraries and
    warms each path, then the first ``python -m mdx_torch`` run in the
    primed copy builds nothing, against the same run in an unprimed
    copy."""
    import os

    from mdx_torch.io import write_synthetic_dicom
    from mdx_torch.io.dicom import TS_JPEG_LL_SV1

    env = {k: v for k, v in os.environ.items()
           if k not in ("MDX_NO_NATIVE", "MDX_TV_MODE", "PYTHONPATH")}
    env["MDX_DB_PATH"] = f"{tmp}/deploy.db"
    primed = _package_copy(f"{tmp}/primed")
    cold = _package_copy(f"{tmp}/cold")
    # 18.b the primer's CLI in a fresh process
    rc, out, err, wall = _fresh(
        ["-m", "mdx_torch.pipeline.prime", "--shapes",
         f"{PRIME_SIZE}x{PRIME_SIZE}", "--tuning"], primed, env)
    lines = err.splitlines()
    for line in lines:
        print(f"prime CLI on {card}: {line}")
    real = os.path.realpath(primed)
    built = [line for line in lines if line.startswith(
        (f"kernel library: {real}/build/",
         f"host codec library: {real}/build/")) and "(built in " in line]
    want = (f"[{PRIME_SIZE}x{PRIME_SIZE}] single-image QA pass",
            "chunk=64 dtype=float32 window=False", "autotune sweep K=9",
            "autotune sweep K=27", "GenAI tool programs",
            f"primed {PRIME_COUNTS['prime'] + PRIME_COUNTS['prime_tuning']}"
            " programs")
    _require(rc == 0 and len(built) == 2
             and all(any(w in line for line in lines) for w in want),
             f"prime CLI: rc {rc}, built {built}: {out[-500:]} "
             f"{err[-2500:]}")
    print(f"prime CLI: rc 0, both libraries built in the copy, every step "
          f"line printed ({wall:.1f} s)")
    # 18.c the first CLI run, primed and not
    path = write_synthetic_dicom(f"{tmp}/noisy_ll.dcm", kind="noisy",
                                 size=PRIME_SIZE, seed=20,
                                 transfer_syntax=TS_JPEG_LL_SV1)
    before = _build_files(primed)
    walls = {}
    for label, root in (("primed", primed), ("unprimed", cold)):
        rc, out, err, walls[label] = _fresh(
            ["-m", "mdx_torch", "--input", path, "--output",
             f"{tmp}/out_{label}", "--no-show"], root, env)
        _require(rc == 0 and out.startswith("# "),
                 f"first CLI run {label}: rc {rc}: {out[-300:]} "
                 f"{err[-2000:]}")
    after, cold_built = _build_files(primed), _build_files(cold)
    _require(after == before,
             f"the primed copy's first CLI run changed build/: "
             f"{sorted(set(after.items()) ^ set(before.items()))}")
    libs = ("mdx_torch_kernels/libmdx_torch_kernels_",
            "mdx_torch_host/libmdx_torch_host_")
    _require(all(any(n.startswith(lib) and n.endswith(".so")
                     for n in before) for lib in libs)
             and all(any(n.startswith(lib) and n.endswith(".so")
                         for n in cold_built) for lib in libs),
             f"libraries: primed {sorted(before)}, unprimed "
             f"{sorted(cold_built)}")
    print(f"first `python -m mdx_torch` run of a {PRIME_SIZE}^2 .4.70 file "
          f"on {card}: primed {walls['primed']!r} s (build/ unchanged: "
          f"{len(before)} files), unprimed {walls['unprimed']!r} s (built "
          f"both libraries)")


def _phase_prime(torch, kernels, parity, check, paths: dict, card: str
                 ) -> None:
    """Phase 18: deploy-time priming (module doc)."""
    import os
    import tempfile

    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    saved = os.environ.get("MDX_DB_PATH")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prime_") as tmp:
            os.environ["MDX_DB_PATH"] = f"{tmp}/runs.db"
            _prime_in_process(torch, kernels, parity, check, paths, card)
            t0 = time.perf_counter()
            _prime_deploy(card, tmp)
            print(f"prime deploy story: {time.perf_counter() - t0:.1f} s")
    finally:
        if saved is None:
            os.environ.pop("MDX_DB_PATH", None)
        else:
            os.environ["MDX_DB_PATH"] = saved
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card and has no CPU mode", file=sys.stderr)
        return 2
    from mdx_torch import kernels, parity
    from mdx_torch.core import enhance as E
    from mdx_torch.core import qa
    from mdx_torch.core.batching import group_limit, map_subbatches
    from mdx_torch.kernels import _build
    from mdx_torch.ops import wavelet as W
    from mdx_torch.tools import (PLAN_PARAMS, bench_config2, card_line,
                                 config2_plan, make_batch)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} (torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, count {torch.cuda.device_count()})")
    print(f"nvidia-smi name, power.limit: {card}")
    print(device_health())
    print(f"tf32 before: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; set both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or line.startswith("#")):
            print("  " + line.strip())

    # ---- 3. kernel parity at [4,512,512] ---------------------------------
    check = KernelCheck(torch, kernels, parity)
    x4 = torch.from_numpy(make_batch(4)).to(dev)
    for k, args in _args_for(torch, x4, PLAN_PARAMS).items():
        check.run("[4,512,512]", k, args)
    _wavelet_cases(torch, check, x4, "[4,512,512]")
    _wavelet_edge_cases(torch, kernels, check, dev)
    _clahe_cases(torch, kernels, check, dev)
    _tv_cases(torch, kernels, check, dev)
    _unsharp_cases(torch, kernels, check, dev)
    _bilateral_cases(torch, kernels, check, dev)
    check.require_ok()
    del x4

    # ---- 4. slice parity, card vs CPU, at [2,512,512] ---------------------
    x2 = make_batch(2)
    failed = []
    # the bench plan runs tv_denoise; the issue-driven chain never does
    for label, fields, tv_ran, run in (
            ("qa_plan", parity.QA_PLAN_FIELDS,
             "tv_denoise" in _bench_plan("cpu")[0].ops,
             lambda x, d: qa.qa_plan(x, *_bench_plan(d))),
            ("qa_deterministic", parity.QA_DETERMINISTIC_FIELDS, False,
             lambda x, d: qa.qa_deterministic(x))):
        on_card = parity.flatten_result(
            run(torch.from_numpy(x2).to(dev), dev), fields)
        on_cpu = parity.flatten_result(
            run(torch.from_numpy(x2.copy()), "cpu"), fields)
        bad = parity.breaches(on_card, on_cpu, tv_ran=tv_ran)
        print(f"slice parity {label} [2,512,512] card vs cpu: "
              f"{len(on_cpu)} fields, enhanced max|d| "
              f"{parity.max_abs(on_card, on_cpu, 'enhanced')!r}, "
              f"score card {on_card['score'].tolist()} "
              f"cpu {on_cpu['score'].tolist()}, breaches {len(bad)}")
        for line in bad:
            print("  " + line)
        if bad:
            failed.append(label)
    _require(not failed, f"card and CPU disagree in {failed}")

    # ---- 5. the main path at 32x512^2 -------------------------------------
    x32 = torch.from_numpy(make_batch(SIZE_N)).to(dev)
    static, dyn = _bench_plan(dev)
    calls: list = []
    paths: dict[str, dict] = {}
    with _recording(torch, kernels, calls):
        (res_plan, res_det), paths["qa_512"] = _run_path(
            torch, kernels, f"qa_plan + qa_deterministic at "
            f"[{SIZE_N},512,512]",
            lambda: (qa.qa_plan(x32, static, dyn), qa.qa_deterministic(x32)))
    for k in DENSE_KERNELS:
        _require(paths["qa_512"][k] > 0,
                 f"kernel {k} was not launched by the 512^2 path")
    for label, res, fields in (
            ("qa_plan", res_plan, parity.QA_PLAN_FIELDS),
            ("qa_deterministic", res_det, parity.QA_DETERMINISTIC_FIELDS)):
        _require_finite(label, parity.flatten_result(res, fields), SIZE_N,
                        512)
    del res_plan, res_det
    check.replay("512^2 main path", calls)
    del calls
    check.require_ok()

    for label, fn in (("qa_plan", lambda: qa.qa_plan(x32, static, dyn)),
                      ("qa_deterministic", lambda: qa.qa_deterministic(x32))):
        med, times = _median_ms(torch, fn, REPS)
        print(f"{label} [{SIZE_N},512,512] on {card}: median {med!r} ms "
              f"of {REPS} reps (min {min(times)!r}, max {max(times)!r}), "
              f"{SIZE_N / med * 1e3!r} img/s")
    _pass_rows(torch, x32, static, dyn, card, trace=True)
    times_512 = _time_kernels(torch, kernels, check, x32, PLAN_PARAMS, card)
    del x32
    # the select kernel on a CT chunk's rows
    chunk = torch.from_numpy(make_batch(CHUNK_N)).to(dev).reshape(CHUNK_N, -1)
    times_select = {"x".join(map(str, chunk.shape)): _time_kernels(
        torch, kernels, check, chunk, None, card,
        cases={"select": _select_args(chunk)})["select"]}
    del chunk
    print(f"phases 1-5: {time.perf_counter() - t_start:.1f} s")

    # ---- 6. the 2048^2 path ------------------------------------------------
    t6 = time.perf_counter()
    x64 = torch.from_numpy(make_batch(CONFIG2_N, BIG)).to(dev)
    print(f"make_batch({CONFIG2_N}, {BIG}) to the card: "
          f"{time.perf_counter() - t6:.1f} s")
    x1 = x64[:1]

    # 6.1 each kernel against its plain version at [1,2048,2048]
    for k, args in _args_for(torch, x1, PLAN_PARAMS).items():
        check.run(f"[1,{BIG},{BIG}]", k, args)
    _wavelet_cases(torch, check, x64[:2], f"[2,{BIG},{BIG}]")
    check.require_ok()

    # 6.2 config 2 at 64x2048^2; the first group's kernel calls recorded
    static2, dyn2 = config2_plan(dev)
    group = group_limit(x64.shape)
    step = bench_config2.step_fn(static2, bare=False)
    groups_run = [0]

    def counted_step(x, d):
        groups_run[0] += 1
        return step(x, d)

    calls = []
    with _recording(torch, kernels, calls, when=lambda: groups_run[0] == 1):
        out2, paths["config2_2048"] = _run_path(
            torch, kernels, f"config 2 at [{CONFIG2_N},{BIG},{BIG}] in "
            f"groups of {group}",
            lambda: map_subbatches(counted_step, x64, dyn2, groups=(group,)))
    for k in ("box_stats", "clahe", "unsharp", "wavelet_denoise"):
        _require(paths["config2_2048"][k] > 0,
                 f"kernel {k} was not launched by config 2")
    _require(tuple(out2.shape) == tuple(x64.shape),
             f"config 2: output shape {tuple(out2.shape)}")
    _require(bool(torch.isfinite(out2).all()), "config 2: non-finite output")
    print(f"config 2 [{CONFIG2_N},{BIG},{BIG}]: finite, {groups_run[0]} "
          f"groups, mean {float(out2.mean())!r}")
    del out2
    check.replay(f"config 2 group 1 of {groups_run[0]}", calls)
    del calls
    check.require_ok()

    # 6.3 qa_plan with the bench plan at 16x2048^2
    x16 = x64[:QA_BIG_N]
    calls = []
    with _recording(torch, kernels, calls):
        res, paths["qa_plan_2048"] = _run_path(
            torch, kernels, f"qa_plan at [{QA_BIG_N},{BIG},{BIG}]",
            lambda: qa.qa_plan(x16, static, dyn))
    for k in DENSE_KERNELS:
        _require(paths["qa_plan_2048"][k] > 0,
                 f"kernel {k} was not launched by qa_plan at 2048^2")
    _require_finite("qa_plan", parity.flatten_result(
        res, parity.QA_PLAN_FIELDS), QA_BIG_N, BIG)
    del res
    check.replay(f"qa_plan [{QA_BIG_N},{BIG},{BIG}]", calls)
    del calls
    check.require_ok()
    torch.cuda.empty_cache()

    # 6.4 config 2, card against CPU at [1,2048,2048]
    t0 = time.perf_counter()
    x1_cpu = x1.cpu()
    fields = ("enhanced", "flags")
    on_card = parity.flatten_result(E.apply_plan(x1, static2, dyn2), fields)
    on_cpu = parity.flatten_result(
        E.apply_plan(x1_cpu, *config2_plan("cpu")), fields)
    bad = parity.breaches(on_card, on_cpu)
    print(f"slice parity config 2 [1,{BIG},{BIG}] card vs cpu: "
          f"{len(on_cpu)} fields, enhanced max|d| "
          f"{parity.max_abs(on_card, on_cpu, 'enhanced')!r}, breaches "
          f"{len(bad)} ({time.perf_counter() - t0:.1f} s)")
    for line in bad:
        print("  " + line)
    _require(not bad, "card and CPU disagree on config 2 at 2048^2")

    # 6.5 times
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    med, times = _median_ms(
        torch, lambda: bench_config2.run_config2(x64, static2, dyn2, group),
        REPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"config 2 [{CONFIG2_N},{BIG},{BIG}] groups of {group} on {card}: "
          f"median {med!r} ms per batch of {REPS} reps (min {min(times)!r}, "
          f"max {max(times)!r}), {CONFIG2_N / med * 1e3!r} img/s, peak "
          f"memory {peak!r} GiB")
    _pass_rows(torch, x16, static, dyn, card, trace=False)
    times_big = _time_kernels(torch, kernels, check, x16, PLAN_PARAMS, card)
    # ... and on the finest db2 HH band whose median is the MAD sigma
    hh = W.dwt2(x16, "db2")[1][2].reshape(QA_BIG_N, -1).abs()
    times_select["x".join(map(str, hh.shape)) + " HH"] = _time_kernels(
        torch, kernels, check, hh, None, card,
        cases={"select": _select_args(hh, (50.0,))})["select"]
    del x64, x1, x16, hh
    print(f"phase 6: {time.perf_counter() - t6:.1f} s")
    torch.cuda.empty_cache()

    # ---- 7. the tuning sweep; 8. raw ingest -------------------------------
    _phase_tuning(torch, kernels, parity, check, paths, card, dev)
    _phase_ingest(torch, kernels, parity, paths, card, dev)
    # ---- 9. the row-sharded path; 10. the 2-D tiles; 11. the probe -------
    times_spatial, runs = _phase_spatial(torch, kernels, parity, check,
                                         paths, card, dev)
    times_spatial.update(_phase_tiles(torch, kernels, parity, check, paths,
                                      card, dev, runs))
    probe_row = _phase_probe(torch, card)
    # ---- 12. the CLI: single files, series and a mixed directory --------
    _phase_cli(torch, kernels, parity, check, paths, card, dev)
    # ---- 13. --spatial: one large slice sharded over the ranks ----------
    _phase_spatial_cli(torch, kernels, parity, check, paths, card, dev)
    # ---- 14. the data axis: sharded entry points, runner, stream --------
    _phase_data(torch, kernels, parity, check, paths, card, dev)
    # ---- 15. the JPEG codecs: compressed files through the CLI ----------
    _phase_codecs(torch, kernels, parity, check, paths, card, dev)
    # ---- 16. the JSON API on the card: served runs, four at once --------
    _phase_serve(torch, kernels, parity, check, paths, card, dev)
    # ---- 17. GenAI mode with a scripted model: planner, tuning, tools ---
    _phase_genai(torch, kernels, parity, check, paths, card, dev)
    # ---- 18. deploy-time priming: in process, then on fresh copies ------
    _phase_prime(torch, kernels, parity, check, paths, card)
    print(f"whole run {time.perf_counter() - t_start:.1f} s")

    rows = []
    shape_512 = f"{SIZE_N}x512x512"
    shape_big = f"{QA_BIG_N}x{BIG}x{BIG}"
    shard = f"1x{SPATIAL_SIZE // SPATIAL_K}x{SPATIAL_SIZE}"
    for k in SPATIAL_KERNELS:
        at = times_spatial[shard][k]
        by_size = {s: t[k] for s, t in times_spatial.items()}
        if k == "tv_shard_step":
            by_size.update({f"{s} {part}": t[part]
                            for s, t in times_spatial.items()
                            for part in ("tv_shard_rebuild",
                                         "tv_shard_solve")})
        rows.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k],
            "launches": sum(p[k] for p in paths.values()),
            "launches_by_path": {p: v[k] for p, v in paths.items()
                                 if p.startswith("spatial")
                                 or p == "prime"},
            "max_abs_err": check.errs[k], "shape": shard,
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": None, "by_size": by_size,
            **({"design": "temporally blocked: s iterations a launch on "
                          "the dense kernel's windows from s-wide halo "
                          "slabs, one all-reduce a launch, one rebuild a "
                          "solve (ms: a launch of s iterations)"}
               if k == "tv_shard_step" else {})})
    for k in DENSE_KERNELS:
        big = times_big[k]
        by_size = {shape_512: times_512[k], shape_big: big}
        if k == "clahe":
            by_size.update({f"{s} clahe_luts": t["clahe_luts"]
                            for s, t in times_spatial.items()})
        if k == "select":
            by_size.update(times_select)
        rows.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k],
            "launches": sum(p[k] for p in paths.values()),
            "launches_by_path": {p: v[k] for p, v in paths.items()},
            "max_abs_err": check.errs[k], "shape": shape_big,
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big.get("library_ms"),
            "by_size": by_size})
    rows.append(probe_row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


HEALTH_FIELDS = ("ecc.errors.uncorrected.volatile.total,"
                 "remapped_rows.pending,remapped_rows.failure,temperature.gpu")


def device_health() -> str:
    """The first card's uncorrected ECC errors since the driver loaded, its
    pending and failed row remappings and its temperature, as nvidia-smi
    gives them (or why it could not): printed at the start and again after
    a failure, so that a fault of the card is told from one of the port."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={HEALTH_FIELDS}",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi {HEALTH_FIELDS}: not read ({e})"
    out = (smi.stdout or smi.stderr).strip().splitlines()
    return (f"nvidia-smi {HEALTH_FIELDS}: "
            f"{out[0] if out else ''} (rc {smi.returncode})")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        print(device_health(), file=sys.stderr)
        sys.exit(1)
    except Exception:
        import traceback

        traceback.print_exc()
        print(device_health(), file=sys.stderr)
        sys.exit(1)
