#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device    — a CUDA card must be present (else exit 1 before any result);
               its name and power limit as nvidia-smi reports them.
2. build     — nvcc builds every kernel of both paths from the sources in
               this checkout (perf/kernels/csrc/encode.cu and trees.cu, one
               nvcc each, started together), with ptxas's report.
3. kernels   — the encode kernel (csrc/encode.cu: K4's one-hot slots and
               K5's bucketize slots, a whole slot table per launch) on the
               card, held bitwise against its plain PyTorch version on the
               same card: as the one-slot wrappers (ragged and full row
               counts, codes out of range, the fixture's real splits with
               NaN, +-inf and values on a split, all four track_nulls x
               track_invalid settings), on random tables of every edge case
               written into strided and misaligned destinations, and on the
               serving fixture's whole 40-slot table at 1024, 37 and a prime
               row count.  Then the one-slot wrappers at a slot's serving
               shape and the fused table at the whole batch's are timed:
               host-inclusive (CUDA events around runs of 20 launches,
               median of 50 runs) and on the device alone (time_device_ms),
               beside the plain version, one PyTorch call as a yardstick
               (one slot) and the card's bound for the bytes moved.
4. serving   — the committed full-width fixture (trained by the JAX package,
               saved in its format) loads through the port's load_model and
               serves 16 batches of 1024 records and one of 37 on the card.
               The launch counters are zeroed just before and read just after:
               the encode kernel must have launched once per batch with the
               table's 40 slots each (no one-slot launch), and the operands
               must have reached the card in 2 copies a batch (one per
               dtype).  The same records through the plan on the CPU (the
               plain versions) must give bitwise-equal prefix vectors and
               equal output records.
4b. serving_server — the same model behind ScoringServer(model,
               max_batch=1024, max_wait_ms=2) on the card (warm, resilience
               on, pipeline depth 2): 8 client threads submit phase 4's
               16 384 records one request each, each thread keeping at most
               256 outstanding.  Every record must equal the CPU plan's
               record for the batch it was served in (the float64 head's
               last bit can depend on a row's place in its batch); the
               encode kernel must launch once per flushed batch with 2
               host->device copies each, with the counters zeroed just
               before; no staging or landing buffer is allocated after
               warm(); every resilience counter and the host path stay at 0
               and the breaker closed.  Records/s, latency p50/p95/p99, the
               mean batch, the pipeline's overlap and stalls and the plan's
               median encode/device/host ms are printed; then the same at
               pipeline depth 0 (lockstep); then a paced load (2 threads, a
               request every 1 ms each) and its latency; then, with the
               FaultHarness: a transient device fault retried, a poison
               record quarantined alone (survivors equal to the CPU plan's
               through the same isolation), a KernelError failing its whole
               batch with nothing quarantined, retried or served by the
               host, an out-of-memory error on every attempt failing its
               batch after the retries and splits (the card plan has no
               host path), and a reloaded copy of the model staged (equal
               fingerprint), promoted and rolled back, records unchanged.
5. tree_kernels — K1 (level histogram), K2 (split scan) and K3 (routing
               select) against their plain versions on the card: K1's int8
               path bitwise (negative node ids, the missing bin, a prime row
               count), its float path within f32_tolerance and bitwise from
               one launch to the next; K2 bitwise on integer-valued
               histograms (a masked feature, K = 1 and 2, empty nodes), and
               on a GBT level's float histograms within
               splitscan.float_agreement's tolerance and bitwise from one
               launch to the next; K3 bitwise on both of its paths (ragged
               rows, one lane, indices out of range, 866 features, the full
               width of each path).  Then each is timed at the training
               path's shapes beside its bound, its design's own byte floor,
               its plan, its plain version and one PyTorch call: K1 at every
               grown level of the sweep (int8 at 150 lanes x 1, 1, 2, 4, 8,
               16 nodes and the refit's 50 lanes x 16; float at 3 lanes x 1,
               1, 2); K2 at RF depth-6 level 5 and at a GBT level (3 lanes x 4
               nodes, float histograms built by K1); K3 at 150, 50 and 3
               lanes.  K1 and K3 are held against their plain versions there
               too (int8 and K3 bitwise, float within its tolerance and
               bitwise run to run).  K2 and K3 are timed on the device alone
               (time_device_ms): their launches are shorter than the host's
               overhead a call.  The library calls run at a stated smaller
               row count where the full one does not fit.
6. training_parity — bench.py's synth data at 16 384 rows x 128 through the
               port's Workflow.train on the card (RF {50 trees, depth 3|6},
               GBT {50 rounds, depth 3}, 3 folds, seed 7), the forest's
               bootstrap draws fed from the JAX package's fixture
               (fixtures/training_trees, tools/make_torch_training_fixture.py):
               the same winner, RF CV metrics within 1e-6 and RF trees
               bitwise, GBT CV metrics within 1e-3 (float histograms sum in
               another order; the largest deviation is printed).  It is also
               the warm-up of phase 7.
7. training  — the same sweep at the full width of bench.py's tree sweep,
               1 048 576 rows x 128, through FeatureBuilder ->
               label.transform_with(selector, vector) -> Workflow.train() on
               the card, with torch's own draws.  The launch counters are
               zeroed just before and read just after: K1, K2 and K3 must
               each launch once per grown level, 3 + 6 + 50*3 = 159 times in
               CV plus the winner's refit levels, K3 by both of its paths.
               A sha256 digest of the CV metric matrix and the winner's tree
               arrays is printed (equal digests: the same fit).  Then
               model.score of 1024 rows on the card, finite.
8. linear_parity — bench.py's synth data at 16 384 rows x 128 with TF32
               off: the port's LogisticRegression and LinearSVC sweeps on the
               card (bench.py's grids, the folds of CrossValidator(3, seed
               7)) within 1e-4 of the JAX package's record per (grid, fold)
               (fixtures/training_linear, tools/make_torch_linear_fixture.py);
               each grid point's refit coefficients and intercept (IRLS
               rtol 1e-4 / atol 1e-5, FISTA and SVC atol 1e-4); and the
               default selector (no models=) through Workflow.train, the
               forest's draws fed from fixtures/training_trees: the
               reference's winner, every CV metric within its family's
               tolerance.  It is also the warm-up of phase 9.
9. training_default — bench.py's full 4-family sweep (LogisticRegression 6
               grids, RandomForest 2, GBT 1, LinearSVC 2; 33 fold-models) at
               1 048 576 rows x 128 through Workflow.train with the default
               selector on the card, the counters zeroed just before and
               read just after: K1-K3 launch 159 times plus the refit levels
               only if a tree won; every CV metric finite and above the
               positive rate.
               Train seconds, fold-models/s, per-family seconds, the winner
               and the peak device memory are printed.  Then model.save ->
               WorkflowModel.load -> score 1024 rows on the card, equal to the
               in-memory model's scores, and evaluate on the training rows
               equal to the train metrics the selector recorded (1e-6).
10. training_raw — the serving_wide pipeline from raw typed columns
               (tests/torch_wide_data.py's copy of the fixture maker's data:
               64 Real with 10 % missing, 8 of them auto-bucketized, 32
               PickList x 30 levels, 4 Binary; transmogrify -> sanity_check
               -> a 2-fold CV LogisticRegression selector) through
               Workflow.train on the card.  (a) At the committed fixture's
               20 000 rows (seed 0): fills, vocabularies, splits and kept
               indices equal to fixtures/serving_wide, the winner and grid
               equal, LR CV metrics within 1e-4 and coefficients within rtol
               1e-4 / atol 1e-5 of it, one encode launch of 40 slots over
               the whole table, and 1024 requests scored within 1e-5 of the
               fixture.  (b) The training flush's encode launch bitwise
               against its plain version on the card, and the flush's
               866-wide vector bitwise against the plain path on the CPU.
               (c) At RAW_ROWS (262 144): Workflow.train's seconds by part
               (host stage fits; each flush: host encode, host->device
               copies, device, encode launch, device->host copies; the
               SanityChecker; the selector), peak device memory, encode
               launches and copies, and the flush's encode launch bitwise
               and timed beside its bound.
11. selection_parity — the default regression and multiclass selectors
               (RegressionModelSelector: LinearRegression, RandomForest, GBT,
               GLM gaussian; MultiClassificationModelSelector: multinomial LR,
               RandomForest, DecisionTree, NaiveBayes behind a DataCutter) at
               4096 rows x 16 on the card, TF32 off, against the JAX
               package's record (fixtures/training_selection,
               tools/make_torch_selection_fixture.py): regression, 3 classes
               and 30 classes (K1 tiles its channels), the forests' draws fed
               from the record.  Every CV metric within its family's
               tolerance (SELECTION_TOL), the reference's winner (or one that
               ties it within the tolerance), the data prep equal, the
               winner's train metrics close.  It is also the warm-up of
               phases 12-14.
12. wide_label_kernels — K1 at 200 grad/hess channels (100 classes),
               65 536 rows x 128: int8 at 150 lanes x 16 nodes bitwise and
               float at 3 lanes x 4 nodes within f32_tolerance, both
               channel-tiled; forest regression's float K1 at 150 lanes x 16
               nodes over 1 048 576 rows; K2 at K = 100 (unstaged) on that
               float level's histograms (float_agreement) and on integer
               ones at 150 lanes x 2 nodes (bitwise).  Each timed beside its
               bound, its plain version and index_add_ (K1, fewer rows; the
               forest regression level's at 65 536 rows, beside the kernel's
               time at that count).
13. training_regression — RegressionModelSelector.with_cross_validation()
               (33 fold-models) at bench.py's 1 048 576 x 128 with a real
               label (numpy seed 0) through Workflow.train on the card, the
               counters zeroed just before and read just after: K1-K3 once
               per grown level (159 in CV, plus a tree winner's refit).
               Seconds, fold-models/s, seconds per family, the winner, the
               launches and the peak device memory are printed.
14. training_multiclass — MultiClassificationModelSelector
               .with_cross_validation() (24 fold-models) at 1 048 576 x 128
               with 10 classes, the same way (18 levels in CV); then at
               65 536 x 128 with 100 classes through the DataCutter, where K1
               must launch channel-tiled and K2 unstaged.
15. families — transmogrify's text, date, list, multi-pick and
               geolocation families (tests/torch_families_data.py: English
               and German free text, a categorical text, an email, 2 pick
               lists, a multi-pick list, a date and a date-time, a date
               list, a text list, a geolocation, 8 Real, 2 Integral, a
               Binary; SanityChecker(correlation_exclusion="hashed_text") and
               a 3-fold CV LogisticRegression selector).  (a) g++ builds the
               native hashing library here (the phase fails if it does not)
               and its blocks equal its Python path's on a Unicode sample.
               (b) At the record's 4096 rows: fitted states equal the JAX
               package's record (fixtures/training_families,
               tools/make_torch_families_fixture.py), the training vector's
               sha256 equal, LR within 1e-4, the pick lists' 2 slots in one
               encode launch, and the JAX-saved model's records on the card
               equal to the CPU plan's and within 1e-12 of the JAX plan's.
               (c) Workflow.train at FAMILY_ROWS (262 144) with the counters
               zeroed just before: seconds by part (stage fits, the SmartText
               fit, the hashing transforms, the flushes, the SanityChecker,
               the selector), the vector width, peak device memory, the
               encode launch (2 slots) bitwise and timed beside its bound,
               and no hashing call on the Python path.  (d) model.save ->
               WorkflowModel.load -> serving_plan() on the card over 16
               batches of 1024 records: one encode launch a batch, records
               equal to the CPU plan's, records/s and the median host encode,
               device and host-remainder ms.  (e) model.serve() answers 2048
               one-record requests, each equal to the plan's record for its
               batch.
16. summary  — nvidia-smi's line, then one {"kernels": [...]} line, then the
               last line {"ok": true, "device": {...}}.

Phase 3 also holds K5 past shared memory (a 5000-split slot, its own launch
reading the splits from global memory) bitwise against its plain version
and times it; phase 5 holds K1's int8 path just above 2**31 // 127 rows
(0/1 weights) bitwise against its plain version and times it, and times
K1's library call at the float level's own 1 048 576 rows.

Any failure raises: the script exits non-zero and prints no last line.
It imports torch and the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BATCH = 1024
N_BATCHES = 16
RAGGED = 37
RUNS = 50
PER_RUN = 20
#: cycles of the sleep kernel that holds the stream while the host enqueues
#: a run of time_device_ms (~3 ms on an H100)
SLEEP_CYCLES = 5_000_000
FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "serving_wide")
TRAIN_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "training_trees")
LINEAR_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "training_linear")
SELECTION_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures",
                                 "training_selection")

# the tree sweep of bench.py: d = 128, 3 folds, RF {50, depth 3|6}, GBT {50, 3}
D = 128
FOLDS = 3
SELECTOR_SEED = 7
RF_GRIDS = [{"num_trees": 50, "max_depth": d} for d in (3, 6)]
GBT_GRIDS = [{"num_rounds": 50, "max_depth": 3}]
FULL_ROWS = 1 << 20
N_BINS = 32
#: grown levels of the sweep: RF depth 3 + depth 6 + GBT 50 rounds x depth 3
CV_LEVELS = 3 + 6 + 50 * 3
#: nodes of K1's histogram at each grown level (the root, then the left
#: children of the level above): RF depth 6, GBT depth 3
RF_LEVEL_NODES = (1, 1, 2, 4, 8, 16)
GBT_LEVEL_NODES = (1, 1, 2)
#: bench.py's 4-family sweep: LR 6 grids + RF 2 + GBT 1 + SVC 2, x 3 folds
DEFAULT_FOLD_MODELS = (6 + 2 + 1 + 2) * FOLDS
#: a bucketize slot past what one launch stages in shared memory (4096)
BIG_SPLITS = 5000
#: one row past the int8 histogram's old fixed limit, (2**31 - 1) // 127
BIG_ROWS = (2 ** 31 - 1) // 127 + 1
#: rows of K1's library call at the int8 RF-CV level: one index_add_ at the
#: full 1 048 576 rows would need a 40 G-element index (322 GB)
INT8_LIBRARY_ROWS = 1 << 16
#: the committed serving_wide fixture's rows (tools/make_torch_serving_fixture.py)
FIXTURE_ROWS = 20000
#: rows of the raw-column training run timed by phase 10
RAW_ROWS = 1 << 18
#: the families record (tools/make_torch_families_fixture.py) and the rows of
#: the families train timed by phase 15
FAMILIES_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures",
                                "training_families")
FAMILY_ROWS = 1 << 18
#: CV metric tolerance of each family against the reference's record
FAMILY_TOL = {"LogisticRegression": 1e-4, "LinearSVC": 1e-4,
              "RandomForestClassifier": 1e-6, "GradientBoostedTreesClassifier": 1e-3}
#: (rtol, atol) of each regression and multiclass family's CV metrics
#: against the reference's record (fixtures/training_selection): the linear
#: families' float32 sums run in another order; the trees' float histograms
#: too, so a near-tie split may go the other way in one tree (regression
#: metrics in the label's units: 2e-3 of their value).  The multiclass
#: forests' int8 histograms are exact, but the reference's compiled split
#: scan sums the classes' gain terms in an order of its own (its fused
#: program differs in the last bit from its own eager run): at 30 classes 3
#: of the 50-tree depth-6 forest's 3150 splits go the other way at near-ties
#: on the CPU, moving a fold's error by up to 1.5e-3 (2 of 1365 rows); their
#: error rates hold to 3e-3
SELECTION_TOL = {"LinearRegression": (0, 1e-5), "GeneralizedLinearRegression": (0, 1e-4),
                 "RandomForestRegressor": (2e-3, 0),
                 "GradientBoostedTreesRegressor": (2e-3, 0),
                 "MultinomialLogisticRegression": (0, 1e-4),
                 "RandomForestClassifier": (0, 3e-3), "DecisionTreeClassifier": (0, 3e-3),
                 "NaiveBayes": (0, 1e-5)}
#: the default regression selector: LinearRegression 6 grids + RF 2 + GBT 1 +
#: GLM 2, and the multiclass one: multinomial LR 3 + RF 2 + DT 2 + NB 1; x 3 folds
REGRESSION_FOLD_MODELS = (6 + 2 + 1 + 2) * FOLDS
MULTICLASS_FOLD_MODELS = (3 + 2 + 2 + 1) * FOLDS
#: grown levels of the default tree families' CV: RF depth 3 + depth 6 (+ GBT
#: 50 x depth 3 for regression, DT depth 3 + depth 6 for multiclass)
REGRESSION_CV_LEVELS = 3 + 6 + 50 * 3
MULTICLASS_CV_LEVELS = 3 + 6 + 3 + 6
#: classes of the full-width multiclass run, and of the wide-label run at
#: WIDE_ROWS rows (200 grad/hess channels: K1 tiles them, K2 reads its
#: histograms where they lie)
MC_CLASSES = 10
WIDE_CLASSES = 100
WIDE_ROWS = 1 << 16
#: rows of K1's library call at 200 channels (a (lane, channel, row,
#: feature) index of the full rows would not fit the card)
WIDE_LIBRARY_ROWS = {True: 256, False: 4096}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = RUNS, per_run: int = PER_RUN,
            warmup: int = 20) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around each run
    of ``per_run`` back-to-back calls, the median over ``runs`` runs after
    warm-up.  For a kernel this small, back-to-back launches measure the
    launch rate the host sustains, which is what bounds it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / per_run for a, b in pairs)


def time_big_ms(fn, runs: int = 5, warmup: int = 1) -> float:
    """Device milliseconds of one call of a kernel that runs for a
    millisecond or more: CUDA events around each call, median of ``runs``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def time_device_ms(fn, runs: int = 21, per_run: int = 10) -> float:
    """Device milliseconds per call of a kernel whose launch is shorter than
    the host's overhead a call: a sleep kernel holds the stream while the
    host enqueues ``per_run`` calls between two CUDA events, so the events
    time the calls back to back on the device; median over ``runs`` runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / per_run for a, b in pairs)


def time_once(fn):
    """Device milliseconds of one call of ``fn`` (CUDA events around it),
    and what it returned."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def synth(n: int, d: int, seed: int = 0):
    """bench.py's ``synth``: standard-normal features, a logistic label."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32) / np.sqrt(d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ beta)))).astype(np.float64)
    return x, y


def regression_label(x, seed: int = 0):
    """A real label for bench.py's x: y = x[:, :8] @ w + 0.5 sin(x[:, 8]) +
    N(0, 0.5^2), w and the noise from numpy ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.normal(size=8)
    return (x[:, :8] @ w + 0.5 * np.sin(x[:, 8])
            + rng.normal(size=len(x)) * 0.5).astype(np.float64)


def multiclass_label(x, classes: int, seed: int = 0):
    """y = argmax(x[:, :16] @ W + Gumbel) over ``classes``, from numpy ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.normal(size=(16, classes))
    return np.argmax(x[:, :16] @ w + rng.gumbel(size=(len(x), classes)),
                     axis=1).astype(np.float64)


def selection_data(n: int, d: int, classes, seed: int = 0):
    """tools/make_torch_selection_fixture.py's data: x standard normal from
    numpy ``seed`` and the label from the same generator (regression where
    ``classes`` is None)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if classes is None:
        w = rng.normal(size=8)
        y = x[:, :8] @ w + 0.5 * np.sin(x[:, 8]) + rng.normal(size=n) * 0.5
    else:
        w = rng.normal(size=(16, classes))
        y = np.argmax(x[:, :16] @ w + rng.gumbel(size=(n, classes)), axis=1)
    return x, y.astype(np.float64)


def make_records(schema: dict, n: int, rng) -> list:
    """Requests from the fixture's schema: ~10 % missing values, ~5 % unseen
    levels, some fields absent altogether."""
    out = []
    for _ in range(n):
        r = {}
        for f in schema["features"]:
            if f.get("response"):
                continue
            u = rng.random()
            if u < 0.02:
                continue                      # field absent from the record
            if u < 0.1:
                r[f["name"]] = None
            elif f["type"] == "Real":
                r[f["name"]] = float(rng.normal())
            elif f["type"] == "Binary":
                r[f["name"]] = bool(rng.random() < 0.3)
            elif u < 0.15:
                r[f["name"]] = f"unseen{int(rng.integers(1000))}"
            else:
                r[f["name"]] = str(rng.choice(f["levels"]))
        out.append(r)
    return out


def phase_kernels(torch, KE, bucketizer_models, dev) -> dict:
    import numpy as np

    rng = np.random.default_rng(0)
    width = 22
    err = {"onehot_codes": 0.0, "bucketize_right_encode": 0.0}
    checked = {"onehot_codes": 0, "bucketize_right_encode": 0}
    for n in (BATCH, RAGGED):
        codes = rng.integers(-1, width + 6, n).astype(np.int32)
        codes[:4] = [-1, width, width + 5, 0]
        c = torch.from_numpy(codes).to(dev)
        got = KE.onehot_codes(c, width)
        ref = KE.onehot_codes_torch(c, width)
        torch.cuda.synchronize()
        check(got.shape == (n, width) and torch.equal(got, ref),
              f"K4 bitwise at n={n}")
        err["onehot_codes"] = max(err["onehot_codes"],
                                  float((got - ref).abs().max()))
        checked["onehot_codes"] += 1
    for m in bucketizer_models:
        splits = np.asarray(m.splits, np.float32)
        s = torch.from_numpy(splits).to(dev)
        for n in (BATCH, RAGGED):
            x = rng.normal(size=n).astype(np.float32)
            x[::7] = np.nan
            x[1], x[2] = np.inf, -np.inf
            finite = splits[np.isfinite(splits)]
            x[3:3 + len(finite)] = finite      # exactly on a split
            xt = torch.from_numpy(x).to(dev)
            for tn in (True, False):
                for ti in (True, False):
                    got = KE.bucketize_right_encode(xt, s, tn, ti)
                    ref = KE.bucketize_right_encode_torch(xt, s, tn, ti)
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape and torch.equal(got, ref),
                          f"K5 bitwise splits={splits.tolist()} n={n} "
                          f"track_nulls={tn} track_invalid={ti}")
                    err["bucketize_right_encode"] = max(
                        err["bucketize_right_encode"],
                        float((got - ref).abs().max()))
                    checked["bucketize_right_encode"] += 1

    # timings at the serving shape: one bucket of 1024 rows, a PickList
    # slot's 22 columns, the fixture's first bucketizer with its flags
    F = torch.nn.functional
    codes = torch.from_numpy(rng.integers(0, width, BATCH).astype(np.int32)).to(dev)
    codes64 = codes.long()
    m = bucketizer_models[0]
    s = torch.from_numpy(np.asarray(m.splits, np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    nb = int(s.shape[0]) - 1
    bw = KE.bucket_width(int(s.shape[0]), m.track_nulls, m.track_invalid)
    t = {
        "onehot_codes": dict(
            ms=time_ms(lambda: KE.onehot_codes(codes, width)),
            plain_ms=time_ms(lambda: KE.onehot_codes_torch(codes, width)),
            library_ms=time_ms(lambda: F.one_hot(codes64, width).float()),
            library="torch.nn.functional.one_hot(codes, width).float()",
            bytes=BATCH * 4 + BATCH * width * 4, shape=[BATCH, width]),
        "bucketize_right_encode": dict(
            ms=time_ms(lambda: KE.bucketize_right_encode(
                x, s, m.track_nulls, m.track_invalid)),
            plain_ms=time_ms(lambda: KE.bucketize_right_encode_torch(
                x, s, m.track_nulls, m.track_invalid)),
            library_ms=time_ms(lambda: F.one_hot(
                (torch.bucketize(x, s) - 1).clamp(0, nb - 1), nb).float()),
            library="composite: torch.bucketize + one_hot (buckets only, "
                    "no invalid/null columns)",
            bytes=BATCH * 4 + int(s.shape[0]) * 4 + BATCH * bw * 4,
            shape=[BATCH, bw], splits=int(s.shape[0])),
    }
    for k, v in t.items():
        v["bound_ms"] = v["bytes"] / HBM_BYTES_PER_S * 1e3
        v["max_abs_err"] = err[k]
        v["parity_cases"] = checked[k]
    for k, v in t.items():  # each one-slot wrapper on the device alone
        v["device_ms"] = time_device_ms(
            (lambda: KE.onehot_codes(codes, width)) if k == "onehot_codes" else
            (lambda: KE.bucketize_right_encode(x, s, m.track_nulls, m.track_invalid)))
    t["bucketize_right_encode"]["splits5000"] = k5_big_splits(torch, KE, dev)
    emit({"phase": "kernels", **{k: v for k, v in t.items()}})
    return t


def k5_big_splits(torch, KE, dev) -> dict:
    """K5 with BIG_SPLITS splits (past shared memory: a launch of its own
    that searches the splits in global memory), bitwise against its plain
    version at ragged row counts and all four flag settings, then timed at
    the serving batch beside its bound, plain version and library call."""
    import numpy as np

    rng = np.random.default_rng(7)
    splits = np.sort(rng.normal(size=BIG_SPLITS)).astype(np.float32)
    splits[0], splits[-1] = -np.inf, np.inf
    s = torch.from_numpy(splits).to(dev)
    cases = 0
    for n in (BATCH, RAGGED, 3001):
        x = (rng.normal(size=n) * 1.5).astype(np.float32)
        x[::7] = np.nan
        x[1], x[2] = np.inf, -np.inf
        x[3:3 + min(n - 3, 500)] = splits[1:1 + min(n - 3, 500)]   # on a split
        xt = torch.from_numpy(x).to(dev)
        for tn in (True, False):
            for ti in (True, False):
                before = KE.bucketize_launches
                got = KE.bucketize_right_encode(xt, s, tn, ti)
                ref = KE.bucketize_right_encode_torch(xt, s, tn, ti)
                torch.cuda.synchronize()
                check(KE.bucketize_launches == before + 1
                      and got.shape == ref.shape and torch.equal(got, ref),
                      f"K5 at {BIG_SPLITS} splits bitwise, n={n} tn={tn} ti={ti}")
                cases += 1
    x = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    nb = BIG_SPLITS - 1
    width = KE.bucket_width(BIG_SPLITS, True, True)
    nbytes = BATCH * 4 + BIG_SPLITS * 4 + BATCH * width * 4
    F = torch.nn.functional
    run = lambda: KE.bucketize_right_encode(x, s, True, True)  # noqa: E731
    return {"splits": BIG_SPLITS, "shape": [BATCH, width], "parity_cases": cases,
            "max_abs_err": 0.0, "ms": time_ms(run), "device_ms": time_device_ms(run),
            "plain_ms": time_ms(lambda: KE.bucketize_right_encode_torch(
                x, s, True, True), runs=11, per_run=5),
            "library_ms": time_ms(lambda: F.one_hot(
                (torch.bucketize(x, s) - 1).clamp(0, nb - 1), nb).float()),
            "library": "composite: torch.bucketize + one_hot (buckets only)",
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def phase_fused(torch, KE, table, dev) -> dict:
    """The encode kernel over whole slot tables: bitwise against its plain
    version on edge-case tables (strided and misaligned destinations, a
    table of two chunks) and on the fixture's table; then timed at the
    serving batch."""
    from torch_encode_cases import fixture_inputs, slot_case

    cases = 0
    for n, n_slots, pad, offset in ((1, 12, 0, 0), (37, 40, 4, 1), (1024, 70, 3, 0),
                                    (997, 70, 4, 2)):
        specs, ins = slot_case(n, 100 + n, dev, n_slots)
        tab = KE.plan_slots(specs)
        w = tab.width
        buf = torch.full((n, offset + w + pad), 7.0, device=dev)
        before = KE.encode_slots_launches
        KE.encode_slots(ins, tab, buf[:, offset:offset + w])
        torch.cuda.synchronize()
        check(KE.encode_slots_launches == before + len(tab.chunks),
              f"one launch per chunk ({len(tab.chunks)})")
        check(torch.equal(buf[:, offset:offset + w], KE.encode_slots_torch(ins, tab))
              and bool((buf[:, :offset] == 7.0).all())
              and bool((buf[:, offset + w:] == 7.0).all()),
              f"fused kernel bitwise on an edge-case table n={n} slots={n_slots} "
              f"offset={offset} pad={pad}")
        cases += 1
    width = table.width
    for n in (BATCH, RAGGED, 997):
        ins = fixture_inputs(table, n, n, dev)
        buf = torch.empty((n, -(-width // 4) * 4), device=dev)[:, :width]
        KE.encode_slots(ins, table, buf)
        torch.cuda.synchronize()
        check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
              f"fused kernel bitwise on the fixture's table at n={n}")
        cases += 1
    ins = fixture_inputs(table, BATCH, 5, dev)
    buf = torch.empty((BATCH, -(-width // 4) * 4), device=dev)[:, :width]
    run = lambda: KE.encode_slots(ins, table, buf)  # noqa: E731
    nbytes = (sum(x.numel() * x.element_size() for x in ins)
              + table.splits.nbytes + BATCH * width * 4)
    out = {"slots": len(table), "columns": width, "rows": BATCH,
           "device_ms": time_device_ms(run), "ms": time_ms(run),
           "plain_ms": time_ms(lambda: KE.encode_slots_torch(ins, table, buf),
                               runs=11, per_run=5),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "parity_cases": cases, "max_abs_err": 0.0}
    emit({"phase": "fused_encode", **out})
    return out


#: the serving_server phase: 8 client threads, each keeping at most
#: CLIENT_WINDOW requests outstanding (2 batches' worth in all, under the
#: server's default max_queue of 4096); the paced load: 2 threads, one
#: request every PACED_MS each, PACED_PER_CLIENT requests each
CLIENTS = 8
CLIENT_WINDOW = 256
PACED_PER_CLIENT = 1000
PACED_MS = 1.0
#: a batch size the fault scenarios submit whole (flush on size only)
FAULT_BATCH = 256
SIZE_ONLY_MS = 60_000
RESILIENCE_ZERO = ("quarantined", "retries", "bucket_splits", "device_failures",
                   "fallback_batches")


def _capture_batches(plan) -> list:
    """Record every batch the plan begins (the records, in order): the
    fixture's head is a float64 product whose last bit can depend on a row's
    place in its batch, so a served record is held to the CPU plan's record
    for the same batch."""
    seen = []
    begin = plan.begin_score

    def recording(records):
        seen.append(list(records))
        return begin(records)
    plan.begin_score = recording
    return seen


def _expected(cpu_plan, batches) -> dict:
    """id(record) -> the CPU plan's record, each batch scored as served."""
    out = {}
    for b in batches:
        for r, row in zip(b, cpu_plan.score(b)):
            out[id(r)] = row
    return out


def _drive_clients(server, records, clients: int, window: int):
    """``clients`` threads submit their share of ``records`` one request at
    a time, each keeping at most ``window`` outstanding; returns the
    (record, future) pairs and the wall seconds to the last result."""
    import threading
    from collections import deque

    shares = [records[k::clients] for k in range(clients)]
    pairs = [[] for _ in range(clients)]
    errors = []

    def client(k):
        try:
            out = deque()
            for r in shares[k]:
                if len(out) >= window:
                    out.popleft().result(timeout=120)
                f = server.submit(r)
                pairs[k].append((r, f))
                out.append(f)
            for f in out:
                f.result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"client threads finished cleanly: {errors[:3]}")
    return [p for ps in pairs for p in ps], wall


def _paced(server, records, per_client: int, every_ms: float):
    """Two threads, one request every ``every_ms`` each."""
    import threading

    futs, lock = [], threading.Lock()

    def client(k):
        for i in range(per_client):
            f = server.submit(records[(2 * i + k) % len(records)])
            with lock:
                futs.append(f)
            time.sleep(every_ms / 1e3)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for f in futs:
        f.result(timeout=120)


def _serve_run(torch, KE, model, records, cpu_plan, depth):
    """One saturating run of the server at pipeline depth ``depth``: every
    record equal to the CPU plan's, one encode launch and 2 host->device
    copies per flushed batch, no allocation, nothing degraded."""
    from transmogrifai_tpu_torch.serve import ScoringServer

    server = ScoringServer(model, max_batch=BATCH, max_wait_ms=2,
                           pipeline_depth=depth)
    try:
        plan = server.plan
        check(plan.device.type == "cuda" and server.batcher.pipeline_depth
              == (2 if depth is None else depth), "server on the card at its depth")
        check(plan.metrics()["buckets_compiled"] == plan.bucket_ladder(),
              "warm built every bucket")
        batches = _capture_batches(plan)
        torch.cuda.synchronize()
        m0 = plan.metrics()
        KE.reset_launch_counts()
        pairs, wall = _drive_clients(server, records, CLIENTS, CLIENT_WINDOW)
        launches = KE.launch_counts()
        m1 = plan.metrics()
        bat = server.batcher.metrics()
        res = server.resilience.metrics()
    finally:
        server.close()
    n_batches = bat["batches"]
    check(bat["completed"] == len(records) and bat["failed"] == 0
          and bat["rejected"] == 0, f"every request completed: {bat}")
    check(len(batches) == n_batches, f"{len(batches)} batches begun == {n_batches} flushed")
    check(launches["encode_slots"] == n_batches
          and launches["encode_slots.slots"] == n_batches * len(plan._encode_table)
          and launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"one encode launch per flushed batch ({n_batches}): {launches}")
    copies = m1["h2d_copies"] - m0["h2d_copies"]
    check(copies == 2 * n_batches, f"host->device copies {copies} == 2 x {n_batches}")
    check(m1["compile_count"] == m0["compile_count"],
          "serving allocated no staging or landing buffers after warm()")
    check(all(res[k] == 0 for k in RESILIENCE_ZERO) and res["breaker"]["state"] == "closed"
          and m1["host_scored_records"] == 0, f"nothing degraded on clean traffic: {res}")
    want = _expected(cpu_plan, batches)
    check(all(f.result() == want[id(r)] for r, f in pairs),
          "every served record == the CPU plan's record for its batch")
    timings = list(plan.batch_timings)[-n_batches:]

    def med(key):
        return statistics.median(t[key] for t in timings)

    return {"pipeline_depth": server.batcher.pipeline_depth,
            "records": len(records), "records_per_s": len(records) / wall,
            "seconds": wall, "batches": n_batches,
            "mean_batch": len(records) / n_batches,
            "latency_p50_ms": bat["latency_p50_ms"],
            "latency_p95_ms": bat["latency_p95_ms"],
            "latency_p99_ms": bat["latency_p99_ms"],
            "overlap_fraction": bat["pipeline"]["overlap_fraction"],
            "stalls": bat["pipeline"]["stalls"],
            "encode_ms_median": med("encode_ms"), "device_ms_median": med("device_ms"),
            "host_ms_median": med("host_ms"),
            "launches": launches["encode_slots"], "h2d_copies_per_batch": copies / n_batches,
            "records_equal_cpu": True}


def _fault_scenarios(model, records, cpu_plan) -> dict:
    """FaultHarness on the card: a transient device fault retried, a poison
    record quarantined alone, a kernel fault failing its whole batch, an
    out-of-memory error failing its batch rather than moving it to the CPU,
    then a blue/green swap to a reloaded copy and back."""
    import torch

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.perf.kernels.dispatch import KernelError
    from transmogrifai_tpu_torch.serve import (FaultHarness, PoisonRecordError,
                                               ResilientScorer, ScoringServer,
                                               TransientScoringError)

    batch = records[:FAULT_BATCH]
    clean = cpu_plan.score(batch)
    out = {}
    server = ScoringServer(model, max_batch=FAULT_BATCH, max_wait_ms=SIZE_ONLY_MS,
                           resilience={"seed": 0, "backoff_base_s": 1e-3})

    def submit(recs):
        futs = [server.submit(r) for r in recs]
        return [f.exception(timeout=120) or f.result(timeout=120) for f in futs]

    def res():
        return server.resilience.metrics()

    try:
        # a transient device fault: retried, the records unchanged
        with FaultHarness().script("device", [TransientScoringError("injected")]):
            got = submit(batch)
        check(got == clean and res()["retries"] == 1 and res()["quarantined"] == 0,
              f"transient fault retried, records unchanged: {res()}")
        out["transient"] = {"retries": res()["retries"], "records_equal_cpu": True}

        # a poison record: only its future fails; the survivors equal the CPU
        # plan's records through the same isolation
        marked = list(batch)
        marked[77] = dict(marked[77], __poison__=1)

        def poisoned(ctx):
            return any("__poison__" in r for r in ctx["records"])

        def harness():
            return FaultHarness().fail_when("encode", poisoned,
                                            lambda: ValueError("injected poison"))
        with harness():
            got = submit(marked)
        with harness():
            want = ResilientScorer(cpu_plan, seed=0).score_isolated(marked)
        check(isinstance(got[77], PoisonRecordError)
              and all(isinstance(g, dict) for i, g in enumerate(got) if i != 77),
              "only the poison record's future failed")
        check([g for i, g in enumerate(got) if i != 77]
              == [w for i, w in enumerate(want) if i != 77],
              "survivors == the CPU plan's through the same isolation")
        check(res()["quarantined"] == 1 and res()["fallback_batches"] == 0,
              f"one record quarantined: {res()}")
        out["poison"] = {"quarantined": res()["quarantined"],
                         "bisect_batches": res()["bisect_batches"],
                         "survivors_equal_cpu": True}

        # a kernel fault: the whole batch fails with it, nothing hidden
        before = res()
        with FaultHarness().script("device", [KernelError("injected launch failure")]):
            got = submit(batch)
        after = res()
        check(all(isinstance(g, KernelError) for g in got),
              "every future of the batch failed with the KernelError")
        check(after["quarantined"] == before["quarantined"]
              and after["fallback_batches"] == 0 and after["retries"] == before["retries"]
              and after["breaker"]["state"] == "closed"
              and server.plan.metrics()["host_scored_records"] == 0,
              f"a kernel fault is not quarantined, retried or served by the host: {after}")
        check(submit(batch) == clean, "the next batch served by the card")
        out["kernel_fault"] = {"failed": len(got), "quarantined_delta": 0,
                               "fallback_batches": after["fallback_batches"]}

        # an out-of-memory error on every attempt: retried, split, then the
        # batch fails with it; the card plan has no host path to hide it
        before = res()
        with FaultHarness().fail_when("device", lambda ctx: True,
                                      lambda: torch.OutOfMemoryError("injected")):
            got = submit(batch)
        after = res()
        check(all(isinstance(g, torch.OutOfMemoryError) for g in got),
              "every future of the batch failed with the out-of-memory error")
        check(after["device_failures"] == before["device_failures"] + 1
              and after["retries"] > before["retries"]
              and after["fallback_batches"] == 0 and after["fallback_records"] == 0
              and server.plan.metrics()["host_scored_records"] == 0,
              f"an out-of-memory batch fails on the card, never on the CPU: {after}")
        check(submit(batch) == clean, "the next batch served by the card")
        out["out_of_memory"] = {"failed": len(got), "fallback_batches": 0,
                                "retries": after["retries"] - before["retries"],
                                "bucket_splits": after["bucket_splits"]
                                - before["bucket_splits"]}

        # blue/green: a reloaded copy of the model
        fp = server.plan.fingerprint
        check(server.stage_candidate(WorkflowModel.load(FIXTURE)) == fp,
              "the reloaded candidate's fingerprint equals the active plan's (TM508 silent)")
        check(submit(batch) == clean, "records unchanged while shadowing")
        shadow = server.shadow_report()
        check(shadow["mirrored_records"] == FAULT_BATCH and shadow["max_abs_delta"] == 0.0,
              f"the candidate mirrored the batch with no delta: {shadow}")
        swap = server.promote()
        check(swap["shared_prefix"] and submit(batch) == clean,
              "promoted: records unchanged")
        back = server.rollback()
        check(back["to_version"] == 1 and submit(batch) == clean,
              "rolled back: records unchanged")
        out["swap"] = {"shared_prefix": swap["shared_prefix"],
                       "shadow_max_abs_delta": shadow["max_abs_delta"],
                       "rolled_back_to": back["to_version"]}
    finally:
        server.close()
    return out


def phase_serving_server(torch, KE, model, batches, cpu_plan) -> dict:
    """Phase 4b: the ScoringServer on the card, records one request each."""
    from transmogrifai_tpu_torch.serve import ScoringServer

    records = [r for b in batches[:N_BATCHES] for r in b]
    t0 = time.perf_counter()
    pipelined = _serve_run(torch, KE, model, records, cpu_plan, None)
    lockstep = _serve_run(torch, KE, model, records, cpu_plan, 0)
    server = ScoringServer(model, max_batch=BATCH, max_wait_ms=2)
    try:
        _paced(server, records, PACED_PER_CLIENT, PACED_MS)
        bat = server.batcher.metrics()
    finally:
        server.close()
    check(bat["completed"] == 2 * PACED_PER_CLIENT and bat["failed"] == 0,
          "paced requests completed")
    paced = {"clients": 2, "every_ms": PACED_MS, "records": bat["completed"],
             "batches": bat["batches"], "mean_batch": bat["completed"] / bat["batches"],
             **{k: bat[k] for k in ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms")}}
    faults = _fault_scenarios(model, records, cpu_plan)
    out = {"pipelined": pipelined, "lockstep": lockstep, "paced": paced,
           "faults": faults, "seconds": time.perf_counter() - t0}
    emit({"phase": "serving_server", **out})
    return out


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tree_modules():
    from transmogrifai_tpu_torch.perf.kernels import histogram as KH
    from transmogrifai_tpu_torch.perf.kernels import routing as KR
    from transmogrifai_tpu_torch.perf.kernels import splitscan as KS

    return KH, KS, KR


def phase_tree_parity(torch, dev) -> dict:
    """K1-K3 against their plain versions on ``dev``; returns the largest
    errors and the number of cases per kernel."""
    import numpy as np

    KH, KS, KR = _tree_modules()
    rng = np.random.default_rng(2)
    out = {"hist_level": {"cases": 0, "max_abs_err": 0.0, "f32_cases": 0,
                          "f32_max_abs_err": 0.0, "f32_max_err_over_tol": 0.0},
           "split_scan": {"cases": 0, "max_abs_err": 0.0, "f32_cases": 0,
                          "f32_index_mismatches": 0, "f32_max_abs_err": 0.0,
                          "f32_max_err_over_tol": 0.0},
           "row_select_lanes": {"cases": 0, "max_abs_err": 0.0}}

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for L, n, d, nn, n_bins in ((3, 7919, 128, 16, N_BINS), (150, 4099, D, 16, N_BINS),
                                (1, 5, 3, 1, 2), (4, 65537, 33, 2, N_BINS)):
        local = rng.integers(-2, nn + 2, (L, n)).astype(np.int32)
        gh = rng.integers(-9, 10, (L, 2, n)).astype(np.int8)
        gh[:, :, ::3] = 0
        binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
        binned[::7, 0] = n_bins
        t = to_dev(local, gh, binned)
        got = KH.hist_level(*t, nn, n_bins, int_exact=True)
        ref = KH.hist_level_torch(*t, nn, n_bins, int_exact=True)
        _sync(torch, dev)
        check(got.dtype == torch.int32 and torch.equal(got, ref),
              f"K1 int bitwise L={L} n={n} d={d} nn={nn}")
        out["hist_level"]["cases"] += 1
    for L, n, d, nn in ((3, FULL_ROWS, D, 2), (12, 50021, 40, 8)):
        local = rng.integers(-1, nn, (L, n)).astype(np.int32)
        gh = rng.normal(size=(L, 2, n)).astype(np.float32)
        binned = rng.integers(0, N_BINS + 1, (n, d)).astype(np.int32)
        t = to_dev(local, gh, binned)
        a = KH.hist_level(*t, nn, N_BINS)
        b = KH.hist_level(*t, nn, N_BINS)
        ref = KH.hist_level_torch(*t, nn, N_BINS)
        tol = KH.f32_tolerance(KH.hist_level_torch(t[0], t[1].abs(), t[2], nn, N_BINS))
        _sync(torch, dev)
        check(torch.equal(a, b), f"K1 f32 bitwise run to run L={L} n={n}")
        err = (a - ref).abs()
        check(bool((err <= tol).all()), f"K1 f32 within tolerance L={L} n={n}")
        h = out["hist_level"]
        h["f32_cases"] += 1
        h["f32_max_abs_err"] = max(h["f32_max_abs_err"], float(err.max()))
        h["f32_max_err_over_tol"] = max(h["f32_max_err_over_tol"],
                                        float((err / tol).max()))
    for K in (1, 2):
        for L, nn, d, n_bins in ((150, 32, D, N_BINS), (3, 4, 6, 8), (2, 1, 1, 2)):
            B = n_bins + 1
            hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
            hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
            hg[0, 0] = 0.0
            hh[0, 0] = 0.0
            G = hg[:, :, :, 0, :].sum(-1)
            H = hh[:, :, :, 0, :].sum(-1)
            mask = np.ones((L, d), np.float32)
            mask[-1, 0] = 0.0
            t = to_dev(hg, hh, G, H, mask)
            for params in ((1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)):
                got = KS.split_scan(*t, n_bins, *params)
                ref = KS.split_scan_torch(*t, n_bins, *params)
                _sync(torch, dev)
                check(all(g.dtype == r.dtype and torch.equal(g, r)
                          for g, r in zip(got, ref)),
                      f"K2 bitwise L={L} nn={nn} K={K} d={d} params={params}")
                out["split_scan"]["cases"] += 1
    # K2 on float histograms at a GBT level (3 fold lanes, depth 3, level 2:
    # 4 nodes), built by K1's float path from logistic grad/hess
    L, nn = FOLDS, 4
    local, gh, binned = _hist_inputs(torch, dev, L, FULL_ROWS, nn, False, 3)
    hist = KH.hist_level(local, gh, binned, nn, N_BINS).reshape(
        L, nn, 2, N_BINS + 1, D).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, D), device=dev)
    mask[-1, 5] = 0.0
    for params in ((1.0, 0.0, 0.0, 1.0), (1.0, 0.5, 0.1, 1.0)):
        args = (hg, hh, G, H, mask, N_BINS, *params)
        got = KS.split_scan(*args)
        again = KS.split_scan(*args)
        _sync(torch, dev)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K2 float bitwise run to run params={params}")
        agree = KS.float_agreement(got, *args)
        check(agree["ok"], f"K2 float within tolerance at a GBT level "
                           f"params={params}: {agree}")
        s2 = out["split_scan"]
        s2["f32_cases"] += 1
        s2["f32_index_mismatches"] += agree["index_mismatches"]
        s2["f32_max_abs_err"] = max(s2["f32_max_abs_err"], agree["max_abs_err"])
        s2["f32_max_err_over_tol"] = max(s2["f32_max_err_over_tol"],
                                         agree["max_err_over_tol"])
    del local, gh, binned, hist, hg, hh, G, H, mask
    paths = out["row_select_lanes"]["paths"] = {}
    for L, n, d in ((1, 37, 5), (150, 4099, D), (3, 100003, D), (7, 4099, 866),
                    (FOLDS * 50, FULL_ROWS, D), (FOLDS, FULL_ROWS, D)):
        binned = rng.integers(0, N_BINS + 1, (n, d)).astype(np.int32)
        idx = rng.integers(-3, d + 3, (L, n)).astype(np.int32)
        b, i = to_dev(binned, idx)
        got = KR.row_select_lanes(b, i)
        _sync(torch, dev)
        check(torch.equal(got, KR.row_select_lanes_torch(b, i)),
              f"K3 bitwise L={L} n={n} d={d}")
        out["row_select_lanes"]["cases"] += 1
        path = KR.plan(L, n, d).path
        paths[path] = paths.get(path, 0) + 1
        del binned, idx, b, i, got
    check(set(paths) == {"tile", "direct"}, f"K3 parity covers both paths: {paths}")
    emit({"phase": "tree_kernels_parity", **out})
    return out


def _hist_inputs(torch, dev, L: int, n: int, nn: int, int_exact: bool, seed: int,
                 root: bool = False):
    """Level inputs shaped like the sweep's: half the rows are right
    children or leaf-stuck (node -1) — at the ``root`` every row is in node
    0 — grad/hess are fold weight x Poisson bootstrap x label (int8) for
    forests, logistic grad/hess (float) for GBT."""
    g = torch.Generator(device=dev).manual_seed(seed)
    binned = torch.randint(0, N_BINS + 1, (n, D), generator=g, device=dev,
                           dtype=torch.int32)
    node = torch.randint(0, 2 * nn, (L, n), generator=g, device=dev, dtype=torch.int32)
    local = torch.where(node % 2 == 0, node // 2, torch.full_like(node, -1))
    if root:
        local = torch.zeros_like(local)
    fold = torch.randint(0, FOLDS, (n,), generator=g, device=dev)
    lane_fold = torch.arange(L, device=dev) % FOLDS
    w = (fold[None, :] != lane_fold[:, None]).to(torch.float32)
    y = torch.randint(0, 2, (n,), generator=g, device=dev).to(torch.float32)
    if int_exact:
        boot = torch.poisson(torch.ones((L, n), device=dev), generator=g)
        wt = w * boot
        gh = torch.stack([-wt * y, wt], dim=1).to(torch.int8).contiguous()
    else:
        p = torch.rand((L, n), generator=g, device=dev)
        gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=1).contiguous()
    return local.contiguous(), gh, binned


def _hist_ops(torch, local, gh, nn: int, d: int = D) -> int:
    """Adds the histogram does on these inputs: 2K channels x d features of
    every (lane, row) whose node is in range and whose grad/hess is not 0."""
    live = (local >= 0) & (local < nn) & (gh != 0).any(dim=1)
    return int(live.sum()) * gh.shape[1] * d


def _index_add_library(torch, local, gh, binned, nn: int):
    """One PyTorch call computing the same histogram: ``index_add_`` of every
    (lane, channel, row, feature) term at its flat (lane, node, channel, bin,
    feature) index, in float32.  Returns (call, output)."""
    L, two_k, n = gh.shape
    d = binned.shape[1]
    width = (N_BINS + 1) * d
    ok = (local >= 0) & (local < nn)
    m = (torch.arange(L, device=local.device)[:, None] * nn
         + local.clamp(0, nn - 1).long())[:, None, :] * two_k \
        + torch.arange(two_k, device=local.device)[None, :, None]
    col = binned.long() * d + torch.arange(d, device=local.device)
    idx = (m[..., None] * width + col[None, None]).reshape(-1)
    src = (gh.to(torch.float32) * ok[:, None, :])[..., None].expand(
        L, two_k, n, d).reshape(-1).contiguous()
    out = torch.zeros(L * nn * two_k * width, dtype=torch.float32, device=local.device)
    return (lambda: out.zero_().index_add_(0, idx, src)), out


def _k1_design_bytes(torch, p: dict, local, gh, d: int, nn: int, int_exact: bool) -> int:
    """Bytes the kernel's design must move on these inputs: every CTA scans
    its lanes' node ids and grad/hess over its rows; the int8 kernel fetches
    the codes of each row live in some lane of a CTA (its node in the CTA's
    tile, a grad/hess not 0), the float kernel the codes of every row of its
    slice; the histograms are written once (the float partials written and
    read again)."""
    L, two_k, n = gh.shape
    ct = p["chan_tiles"]
    scan = p["node_tiles"] * p["feat_tiles"] * L * n * (
        4 * ct + two_k * gh.element_size())
    out_b = L * nn * two_k * (N_BINS + 1) * d * 4
    if not int_exact:
        codes = p["lane_groups"] * ct * p["node_tiles"] * n * d * 4
        partials = 2 * out_b * p["slices"] if p["slices"] > 1 else 0
        return scan + codes + partials + out_b
    fetched = 0
    for c0 in range(0, two_k, p["CT"]):
        live = (local >= 0) & (local < nn) & (gh[:, c0:c0 + p["CT"]] != 0).any(dim=1)
        tile = torch.where(live, local // p["NT"], torch.full_like(local, -1))
        for lg in range(p["lane_groups"]):
            tl = tile[lg * p["G"]:(lg + 1) * p["G"]]
            for nt in range(p["node_tiles"]):
                fetched += int((tl == nt).any(dim=0).sum())
    return scan + fetched * d * 4 + out_b * (2 if p["slices"] > 1 else 1)


def _k1_level(torch, KH, bound, local, gh, binned, nn: int, root: bool,
              int_exact: bool) -> dict:
    """K1 at one level: its time, bound, design floor and plain version's
    time; held bitwise (int8) or within f32_tolerance and bitwise run to run
    (float) against the plain version."""
    L, two_k, n = gh.shape
    run = lambda: KH.hist_level(local, gh, binned, nn, N_BINS,  # noqa: E731
                                int_exact=int_exact)
    p = KH.plan(L, n, D, nn, two_k, N_BINS, int_exact)
    e = {"path": "int8" if int_exact else "float32", "root": root,
         "shape": [L, nn, n, D, N_BINS + 1], "ms": time_big_ms(run),
         **bound(KH.bound_bytes(L, n, D, nn, two_k, N_BINS, int_exact),
                 _hist_ops(torch, local, gh, nn)),
         "plan": {k: p[k] for k in ("G", "CT", "NT", "FT", "threads", "R", "slices",
                                    "chan_tiles", "merge", "smem")}}
    design = _k1_design_bytes(torch, p, local, gh, D, nn, int_exact)
    e.update(design_bytes=design, design_floor_ms=design / HBM_BYTES_PER_S * 1e3)
    got = run()
    e["plain_ms"], ref = time_once(lambda: KH.hist_level_torch(
        local, gh, binned, nn, N_BINS, int_exact=int_exact))
    what = f"K1 {e['path']} at L={L} nn={nn} root={root}"
    if int_exact:
        check(torch.equal(got, ref), f"{what}: bitwise equal to the plain version")
        e["max_abs_err"] = 0.0
    else:
        again = run()
        check(torch.equal(got, again), f"{what}: bitwise run to run")
        err = (got - ref).abs()
        tol = KH.f32_tolerance(KH.hist_level_torch(local, gh.abs(), binned, nn, N_BINS))
        check(bool((err <= tol).all()), f"{what}: within f32_tolerance")
        e.update(max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()))
        del again, err, tol
    del got, ref
    return e


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, the larger."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": nbytes, "ops": ops}


def phase_tree_timing(torch, dev) -> dict:
    """K1-K3 timed at the training path's shapes, with bounds, plain and
    library times."""
    KH, KS, KR = _tree_modules()
    t = {}

    # K1 at every grown level of the sweep: the int8 path at 150 lanes (RF
    # CV, depth 6: the root, then 1, 2, 4, 8, 16 left children; depth 3's
    # levels are its first three) and 50 lanes (the refit's deepest level);
    # the float path at 3 lanes (GBT, depth 3: 1, 1, 2)
    levels = ([(FOLDS * 50, nn, i == 0, True) for i, nn in enumerate(RF_LEVEL_NODES)]
              + [(50, RF_LEVEL_NODES[-1], False, True)]
              + [(FOLDS, nn, i == 0, False) for i, nn in enumerate(GBT_LEVEL_NODES)])
    rows = []
    for i, (L, nn, root, int_exact) in enumerate(levels):
        local, gh, binned = _hist_inputs(torch, dev, L, FULL_ROWS, nn, int_exact,
                                         10 + i, root=root)
        e = _k1_level(torch, KH, bound, local, gh, binned, nn, root, int_exact)
        rows.append(e)
        # the library call at the deepest RF-CV level (at INT8_LIBRARY_ROWS:
        # the full rows' index does not fit the card) and at the deepest GBT
        # level (at its full rows)
        if (L, nn, int_exact) in ((FOLDS * 50, RF_LEVEL_NODES[-1], True),
                                  (FOLDS, GBT_LEVEL_NODES[-1], False)):
            lib_rows = INT8_LIBRARY_ROWS if int_exact else FULL_ROWS
            sl = (local[:, :lib_rows].contiguous(), gh[..., :lib_rows].contiguous(),
                  binned[:lib_rows])
            call, _ = _index_add_library(torch, *sl, nn)
            e.update(library_rows=lib_rows, ms_at_library_rows=time_big_ms(
                lambda: KH.hist_level(*sl, nn, N_BINS, int_exact=int_exact)),
                library_ms=time_big_ms(call),
                library="index_add_ of the (lane, channel, row, feature) terms "
                        "at their flat (lane, node, channel, bin, feature) index, "
                        "float32 (a composite: the index is built outside the call)")
            del sl, call
        del local, gh, binned
        torch.cuda.empty_cache()
    deepest = next(e for e in rows if e["path"] == "int8"
                   and e["shape"][:2] == [FOLDS * 50, RF_LEVEL_NODES[-1]])
    gbt = next(e for e in rows if e["path"] == "float32"
               and e["shape"][:2] == [FOLDS, GBT_LEVEL_NODES[-1]] and not e["root"])
    t["hist_level"] = {**deepest, "f32": gbt, "levels": rows,
                       "int8_past_16_9m_rows": k1_big_rows(torch, KH, dev, bound)}

    t["split_scan"] = k2_timings(torch, KS, KH, dev, bound)
    t["row_select_lanes"] = k3_timings(torch, KR, dev, bound)
    emit({"phase": "tree_kernels_timing", **t})
    torch.cuda.empty_cache()
    return t


def k1_big_rows(torch, KH, dev, bound) -> dict:
    """K1's int8 path at BIG_ROWS (+ 1001) rows, one lane of 0/1 fold
    weights: the wrapper bounds the int32 sums from the data instead of
    refusing; bitwise against the plain version, then timed."""
    n, d, nn = BIG_ROWS + 1001, 8, 2
    g = torch.Generator(device=dev).manual_seed(21)
    binned = torch.randint(0, N_BINS + 1, (n, d), generator=g, device=dev,
                           dtype=torch.int32)
    local = torch.randint(-1, nn, (1, n), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int8)
    gh = torch.stack([-w, w])[None].contiguous()
    run = lambda: KH.hist_level(local, gh, binned, nn, N_BINS, int_exact=True)  # noqa: E731
    before = KH.launches
    got = run()
    _sync(torch, dev)
    check(KH.launches == before + 1, "K1 int8 past 16.9M rows launched once")
    plain_ms, ref = time_once(lambda: KH.hist_level_torch(local, gh, binned, nn,
                                                          N_BINS, int_exact=True))
    check(torch.equal(got, ref), f"K1 int8 bitwise at {n} rows")
    out = {"path": "int8", "shape": [1, nn, n, d, N_BINS + 1],
           "abs_sum_bound": KH.int_abs_sum_bound(gh), "ms": time_big_ms(run),
           "plain_ms": plain_ms, "max_abs_err": 0.0, "library_ms": None,
           **bound(KH.bound_bytes(1, n, d, nn, 2, N_BINS, True),
                   _hist_ops(torch, local, gh, nn, d))}
    del binned, local, w, gh, got, ref
    torch.cuda.empty_cache()
    return out


def _scan_inputs(torch, KH, dev, gbt: bool, seed: int, missing: bool = False):
    """K2's inputs at a sweep level: the RF-CV deepest level's integer
    histograms (150 lanes x 32 nodes, seeded) or a GBT level's float ones
    (3 lanes x 4 nodes), built by K1 from logistic grad/hess.  Without
    ``missing`` the missing-value bin is empty, as in the sweep (bench.py's
    synth data has no missing values)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if not gbt:
        shape = (FOLDS * 50, 32, 1, D, N_BINS + 1)
        hg = torch.randint(-20, 20, shape, generator=g, device=dev).to(torch.float32)
        hh = torch.randint(0, 30, shape, generator=g, device=dev).to(torch.float32)
        params = (0.0, 0.0, 0.0, 1.0)
    else:
        L, nn = FOLDS, 4
        local, gh, binned = _hist_inputs(torch, dev, L, FULL_ROWS, nn, False, seed)
        hist = KH.hist_level(local, gh, binned, nn, N_BINS).reshape(
            L, nn, 2, N_BINS + 1, D).transpose(-1, -2)
        hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
        params = (1.0, 0.0, 0.0, 1.0)
    if not missing:
        hg[..., N_BINS] = 0.0
        hh[..., N_BINS] = 0.0
    G = hg[:, :, :, 0, :].sum(-1).contiguous()
    H = hh[:, :, :, 0, :].sum(-1).contiguous()
    mask = torch.ones((hg.shape[0], D), device=dev)
    return (hg, hh, G, H, mask, N_BINS, *params)


def k2_timings(torch, KS, KH, dev, bound) -> dict:
    """K2 at the RF-CV deepest level (integer histograms: held bitwise to
    the plain version) and at a GBT level (float: within float_agreement and
    bitwise run to run), each with its bound, design floor and plan; the
    missing-value bin empty as in the sweep, and filled (``*_missing``)."""
    out = {}
    for name, gbt, seed, missing in (
            ("rf_deepest", False, 12, False), ("gbt_level", True, 14, False),
            ("rf_deepest_missing", False, 12, True),
            ("gbt_level_missing", True, 14, True)):
        args = _scan_inputs(torch, KH, dev, gbt, seed, missing)
        L, nn, K, d, B = args[0].shape
        p = KS.plan(L, nn, K, d, N_BINS)
        run = lambda: KS.split_scan(*args)  # noqa: E731
        got, again = run(), run()
        _sync(torch, dev)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K2 bitwise run to run at {name}")
        e = {"shape": [L, nn, K, d, B], "float_hists": gbt, "missing_bin": missing,
             "ms": time_device_ms(run),
             **bound(KS.bound_bytes(L, nn, K, d, N_BINS),
                     KS.bound_ops(L, nn, K, d, N_BINS)),
             "plan": p._asdict(), "library_ms": None, "library": None}
        # the staged design copies each histogram word once: its byte floor
        # is the bound's
        e.update(design_bytes=e["bytes"],
                 design_floor_ms=e["bytes"] / HBM_BYTES_PER_S * 1e3)
        e["plain_ms"], ref = time_once(lambda: KS.split_scan_torch(*args))
        if gbt:
            agree = KS.float_agreement(got, *args)
            check(agree["ok"], f"K2 float within tolerance at {name}: {agree}")
            e["agreement"] = agree
        else:
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"K2 bitwise to the plain version at {name}")
        out[name] = e
        del args, got, again, ref
        torch.cuda.empty_cache()
    return {**out.pop("rf_deepest"), **out}


def k3_timings(torch, KR, dev, bound) -> dict:
    """K3 over the full rows at 150 lanes (RF CV), 50 (the forest refit) and
    3 (GBT CV), each held bitwise to its plain version, with its bound,
    design floor, plan and the library call."""
    k3 = {}
    for L in (FOLDS * 50, 50, FOLDS):
        g = torch.Generator(device=dev).manual_seed(13 + L)
        binned = torch.randint(0, N_BINS + 1, (FULL_ROWS, D), generator=g,
                               device=dev, dtype=torch.int32)
        idx = torch.randint(0, D, (L, FULL_ROWS), generator=g, device=dev,
                            dtype=torch.int32)
        flat = (torch.arange(FULL_ROWS, device=dev)[None, :] * D + idx.long())
        p = KR.plan(L, FULL_ROWS, D)
        design = KR.design_bytes(p, L, FULL_ROWS, D)
        e = {"shape": [L, FULL_ROWS, D],
             "ms": time_device_ms(lambda: KR.row_select_lanes(binned, idx)),
             **bound(KR.bound_bytes(L, FULL_ROWS, D), 0),
             "design_bytes": design,
             "design_floor_ms": design / HBM_BYTES_PER_S * 1e3,
             "plan": p._asdict(),
             "library_ms": time_device_ms(lambda: torch.take(binned, flat)),
             "library": "torch.take at the flat (row, feature) index (a "
                        "composite: no out-of-range rule, the index built "
                        "outside the call)"}
        got = KR.row_select_lanes(binned, idx)
        e["plain_ms"], ref = time_once(lambda: KR.row_select_lanes_torch(binned, idx))
        check(torch.equal(got, ref), f"K3 bitwise at {L} lanes x {FULL_ROWS} rows")
        k3[L] = e
        del binned, idx, flat, got, ref
        torch.cuda.empty_cache()
    return {**k3[FOLDS * 50], "lanes50": k3[50], "lanes3": k3[FOLDS]}


def fit_digest(summary, win) -> str:
    """sha256 of the CV metric matrix (model, grid, fold values) and the
    winner's tree arrays: two fits with equal digests chose alike."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for ev in summary.validation_results:
        h.update(f"{ev.model_name}|{json.dumps(ev.grid, sort_keys=True)}".encode())
        h.update(np.asarray(ev.metric_values, np.float64).tobytes())
    h.update(type(win).__name__.encode())
    for k in sorted(win.trees):
        a = np.ascontiguousarray(win.trees[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def train_selector(torch, x, y, dev, default: bool = False):
    """bench.py's sweep through the port's user entry points -- its tree
    families, or with ``default`` the default selector (no ``models=``:
    LogisticRegression, RandomForest, GBT, LinearSVC); returns
    (WorkflowModel, selector, prediction feature, train seconds)."""
    import numpy as np

    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector,
        FeatureBuilder,
        Workflow,
    )
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.models.trees import (
        GradientBoostedTreesClassifier,
        RandomForestClassifier,
    )
    from transmogrifai_tpu_torch.types import RealNN

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
    if default:
        selector = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=FOLDS, seed=SELECTOR_SEED)
    else:
        selector = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=FOLDS, seed=SELECTOR_SEED,
            models=[(RandomForestClassifier(), RF_GRIDS),
                    (GradientBoostedTreesClassifier(), GBT_GRIDS)])
    pred = label.transform_with(selector, vec)
    ds = Dataset({"label": Column(RealNN, y.astype(np.float64),
                                  np.ones(len(y), dtype=np.bool_)),
                  "features": Column.vector(x)})
    _sync(torch, dev)
    t0 = time.perf_counter()
    model = Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device=dev)
    _sync(torch, dev)
    return model, selector, pred, time.perf_counter() - t0


class FixtureDraws:
    """Within the block, the forest's bootstrap draws come from the JAX
    package's record (``fixture``: fixtures/training_trees or
    training_selection, seed 42 + 1, 50 trees, its rows), fed through the
    port's one seam, ``trees.draw_bootstrap``."""

    def __init__(self, torch, fixture: str = TRAIN_FIXTURE):
        import numpy as np

        from transmogrifai_tpu_torch.models import trees as TT

        with open(os.path.join(fixture, "summary.json")) as fh:
            recipe = json.load(fh)["recipe"]
        self.expect = (recipe["rf_boot_seed"], 1.0, 50,
                       recipe.get("synth_rows", recipe.get("rows")))
        with np.load(os.path.join(fixture, "arrays.npz")) as npz:
            self.boot = torch.from_numpy(npz["rf_boot"].astype(np.float32))
        self.TT = TT

    def draw(self, seed, rate, n_trees, rows, device):
        check((seed, rate, n_trees, rows) == self.expect,
              f"forest draws asked for ({seed}, {rate}, {n_trees}, {rows})")
        return self.boot.to(device)

    def __enter__(self):
        self.port_draws = self.TT.draw_bootstrap
        self.TT.draw_bootstrap = self.draw
        return self

    def __exit__(self, *exc):
        self.TT.draw_bootstrap = self.port_draws


def _tree_arrays_equal(trees: dict, arrays, prefix: str) -> bool:
    import numpy as np

    return all(np.asarray(trees[k]).shape == arrays[f"{prefix}_{k}"].shape
               and np.array_equal(np.asarray(trees[k]), arrays[f"{prefix}_{k}"])
               for k in ("feat", "thr_bin", "miss_left", "is_leaf", "value"))


def phase_training_parity(torch, dev) -> dict:
    """The 16 384-row sweep against the JAX package's fixture, the forest's
    draws fed from it."""
    import numpy as np

    from transmogrifai_tpu_torch.models import trees as TT

    with open(os.path.join(TRAIN_FIXTURE, "summary.json")) as fh:
        rec = json.load(fh)
    with np.load(os.path.join(TRAIN_FIXTURE, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    recipe = rec["recipe"]
    n = int(recipe["synth_rows"])
    x, y = synth(n, int(recipe["features"]), int(recipe["data_seed"]))
    with FixtureDraws(torch):
        model, selector, _, seconds = train_selector(torch, x, y, dev)
        fitted = model.fitted[selector.uid]
        refits = {g["max_depth"]: TT.RandomForestClassifier(**g)._fit_arrays(
            x, y.astype(np.float32), np.ones(n, np.float32), dev) for g in RF_GRIDS}
    summary = fitted.summary
    check(summary.best_model_name == rec["winner"]["name"]
          and summary.best_grid == rec["winner"]["grid"],
          f"winner {summary.best_model_name} {summary.best_grid} == fixture "
          f"{rec['winner']}")
    dev_max = {"RandomForestClassifier": 0.0, "GradientBoostedTreesClassifier": 0.0}
    tol = {"RandomForestClassifier": 1e-6, "GradientBoostedTreesClassifier": 1e-3}
    check(len(summary.validation_results) == len(rec["validation"]), "evaluations")
    for ev, ref in zip(summary.validation_results, rec["validation"]):
        check(ev.model_name == ref["model"] and ev.grid == ref["grid"],
              f"evaluation order {ev.model_name} {ev.grid}")
        d = float(np.max(np.abs(np.asarray(ev.metric_values) - np.asarray(ref["values"]))))
        dev_max[ev.model_name] = max(dev_max[ev.model_name], d)
        check(d <= tol[ev.model_name],
              f"{ev.model_name} {ev.grid} CV metrics {ev.metric_values} vs "
              f"{ref['values']} (|diff| {d} > {tol[ev.model_name]})")
    for depth, m in refits.items():
        check(_tree_arrays_equal(m.trees, arrays, f"rf_depth{depth}"),
              f"RF depth-{depth} refit trees bitwise equal to the fixture")
    check(np.array_equal(fitted.model.edges, arrays["edges"]), "edges bitwise")
    win = fitted.model
    structure = float(np.mean([np.array_equal(np.asarray(win.trees[k]),
                                              arrays[f"winner_{k}"])
                               for k in ("feat", "thr_bin", "miss_left", "is_leaf")]))
    value_dev = float(np.max(np.abs(np.asarray(win.trees["value"], np.float64)
                                    - arrays["winner_value"])))
    out = {"rows": n, "seconds": seconds, "winner": summary.best_model_name,
           "winner_grid": summary.best_grid,
           "rf_cv_max_abs_dev": dev_max["RandomForestClassifier"],
           "gbt_cv_max_abs_dev": dev_max["GradientBoostedTreesClassifier"],
           "rf_refit_trees_bitwise": True,
           "winner_structure_arrays_equal": structure,
           "winner_value_max_abs_dev": value_dev,
           "train_evaluation": summary.train_evaluation,
           "fixture_train_evaluation": rec["train_evaluation"]}
    emit({"phase": "training_parity", **out})
    return out


def _reset_all(KE) -> None:
    KH, KS, KR = _tree_modules()
    for m in (KE, KH, KS, KR):
        m.reset_launch_counts()


def _all_counts(KE) -> dict:
    KH, KS, KR = _tree_modules()
    out = {}
    for m in (KE, KH, KS, KR):
        out.update(m.launch_counts())
    return out


def phase_training(torch, KE, dev) -> dict:
    """bench.py's tree sweep at full width through Workflow.train on the card."""
    import numpy as np

    from transmogrifai_tpu_torch.data.dataset import Column, Dataset

    t0 = time.perf_counter()
    x, y = synth(FULL_ROWS, D, 0)
    data_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    model, selector, pred, seconds = train_selector(torch, x, y, dev)
    launches = _all_counts(KE)
    fitted = model.fitted[selector.uid]
    summary = fitted.summary
    win = fitted.model
    refit_levels = win.max_depth * (win.n_trees if "GBT" in type(win).__name__ else 1)
    expected = CV_LEVELS + refit_levels
    for k in ("hist_level", "split_scan", "row_select_lanes"):
        check(launches[k] == expected,
              f"{k} launched {launches[k]} times, expected {CV_LEVELS} + {refit_levels}")
    # K3: the forests' 150 lanes take the tile path, GBT's 3 the direct one
    check(launches["row_select_lanes.tile"] >= 3 + 6
          and launches["row_select_lanes.direct"] >= 50 * 3,
          f"K3 launched by both paths: {launches}")
    check(launches["onehot_codes"] == launches["bucketize_right_encode"]
          == launches["encode_slots"] == 0,
          "the training path launches no serving kernel")
    pos_rate = float(y.mean())
    for ev in summary.validation_results:
        check(all(np.isfinite(v) for v in ev.metric_values), f"finite {ev}")
        check(ev.mean_metric > pos_rate,
              f"{ev.model_name} {ev.grid} auPR {ev.mean_metric} above {pos_rate}")
    n_score = 1024
    scored = model.score(Dataset({"features": Column.vector(x[:n_score])}),
                         device=None if dev.type == "cuda" else dev)
    col = scored[pred.name]
    check(col.data.shape[0] == n_score and np.isfinite(col.data).all()
          and np.all((col.prob >= 0) & (col.prob <= 1)),
          "model.score of 1024 rows on the card is finite")
    fold_models = (len(RF_GRIDS) + len(GBT_GRIDS)) * FOLDS
    out = {"rows": FULL_ROWS, "features": D, "fold_models": fold_models,
           "train_seconds": seconds, "fold_models_per_s": fold_models / seconds,
           "synth_seconds_host": data_s,
           "phase_seconds": selector.last_fit_profile,
           "winner": summary.best_model_name, "winner_grid": summary.best_grid,
           "cv": [{"model": ev.model_name, "grid": ev.grid,
                   "values": ev.metric_values, "mean": ev.mean_metric}
                  for ev in summary.validation_results],
           "positive_rate": pos_rate,
           "train_evaluation": summary.train_evaluation,
           "launches": launches, "expected_tree_launches": expected,
           "fit_digest": fit_digest(summary, win),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None,
           "score_rows": n_score}
    emit({"phase": "training", **out})
    return out


def phase_linear_parity(torch, dev) -> dict:
    """The linear families at 16 384 rows against the JAX package's record
    (TF32 off): the sweeps per (grid, fold), each grid point's refit, and
    the default selector's winner and CV table."""
    import numpy as np

    from transmogrifai_tpu_torch import LinearSVC, LogisticRegression
    from transmogrifai_tpu_torch.evaluators.base import BinaryClassificationEvaluator
    from transmogrifai_tpu_torch.models.tuning import CrossValidator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(LINEAR_FIXTURE, "summary.json")) as fh:
        rec = json.load(fh)
    with np.load(os.path.join(LINEAR_FIXTURE, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    recipe = rec["recipe"]
    n = int(recipe["synth_rows"])
    x, y = synth(n, int(recipe["features"]), int(recipe["data_seed"]))
    y32 = y.astype(np.float32)
    ones = np.ones(n, np.float32)
    ev = BinaryClassificationEvaluator(recipe["metric"])
    tw, vw = CrossValidator(ev, num_folds=int(recipe["folds"]),
                            seed=int(recipe["selector_seed"])).fold_weights(y32, ones)
    t0 = time.perf_counter()
    cv = {"lr": LogisticRegression().cv_sweep(x, y32, tw, vw, recipe["lr_grids"],
                                              ev.metric_fn(), dev),
          "svc": LinearSVC().cv_sweep(x, y32, tw, vw, recipe["svc_grids"],
                                      ev.metric_fn(), dev)}
    sweep_s = time.perf_counter() - t0
    out = {"rows": n, "sweep_seconds": sweep_s}
    for fam in ("lr", "svc"):
        d = float(np.max(np.abs(cv[fam] - np.asarray(rec[f"{fam}_cv"]))))
        check(d <= 1e-4, f"{fam} CV metrics within 1e-4 of the reference (|diff| {d})")
        out[f"{fam}_cv_max_abs_dev"] = d
    for fam, cls in (("lr", LogisticRegression), ("svc", LinearSVC)):
        coef_dev = icpt_dev = 0.0
        for i, g in enumerate(recipe[f"{fam}_grids"]):
            m = cls(**g)._fit_arrays(x, y32, ones, dev)
            want_c, want_b = arrays[f"{fam}_coef"][i], arrays[f"{fam}_intercept"][i]
            irls = fam == "lr" and g.get("elastic_net", 0.0) <= 0.0
            rtol, atol = (1e-4, 1e-5) if irls else (0.0, 1e-4)
            ok = np.allclose(m.coef, want_c, rtol=rtol, atol=atol) and \
                np.allclose(m.intercept, want_b, rtol=rtol, atol=atol)
            check(ok, f"{fam} {g} refit coefficients and intercept within "
                      f"rtol {rtol} atol {atol} of the reference")
            coef_dev = max(coef_dev, float(np.max(np.abs(m.coef - want_c))))
            icpt_dev = max(icpt_dev, abs(m.intercept - float(want_b)))
        out[f"{fam}_refit_coef_max_abs_dev"] = coef_dev
        out[f"{fam}_refit_intercept_max_abs_dev"] = icpt_dev
    with FixtureDraws(torch):
        model, selector, _, seconds = train_selector(torch, x, y, dev, default=True)
    summary = model.fitted[selector.uid].summary
    check((summary.best_model_name, summary.best_grid)
          == (rec["winner"]["name"], rec["winner"]["grid"]),
          f"default selector's winner {summary.best_model_name} {summary.best_grid} "
          f"== the reference's {rec['winner']}")
    check(len(summary.validation_results) == len(rec["validation"]), "evaluations")
    dev_max = {k: 0.0 for k in FAMILY_TOL}
    for e, ref in zip(summary.validation_results, rec["validation"]):
        check((e.model_name, e.grid) == (ref["model"], ref["grid"]),
              f"evaluation order {e.model_name} {e.grid}")
        d = float(np.max(np.abs(np.asarray(e.metric_values) - np.asarray(ref["values"]))))
        dev_max[e.model_name] = max(dev_max[e.model_name], d)
        check(d <= FAMILY_TOL[e.model_name],
              f"{e.model_name} {e.grid} CV metrics {e.metric_values} vs "
              f"{ref['values']} (|diff| {d})")
    out.update(default_seconds=seconds, winner=summary.best_model_name,
               winner_grid=summary.best_grid, default_cv_max_abs_dev=dev_max,
               train_evaluation=summary.train_evaluation,
               fixture_train_evaluation=rec["train_evaluation"],
               tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    emit({"phase": "linear_parity", **out})
    return out


def phase_training_default(torch, KE, dev) -> dict:
    """bench.py's 4-family sweep at full width with the default selector,
    then save -> load -> score and evaluate of the model it chose."""
    import tempfile

    import numpy as np

    from transmogrifai_tpu_torch import Evaluators, WorkflowModel
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.types import RealNN

    t0 = time.perf_counter()
    x, y = synth(FULL_ROWS, D, 0)
    data_s = time.perf_counter() - t0
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    model, selector, pred, seconds = train_selector(torch, x, y, dev, default=True)
    launches = _all_counts(KE)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    fitted = model.fitted[selector.uid]
    summary = fitted.summary
    win = fitted.model
    refit_levels = 0
    if hasattr(win, "trees"):
        refit_levels = win.max_depth * (win.n_trees if "GBT" in type(win).__name__ else 1)
    expected = CV_LEVELS + refit_levels
    for k in ("hist_level", "split_scan", "row_select_lanes"):
        check(launches[k] == expected,
              f"{k} launched {launches[k]} times, expected {CV_LEVELS} + {refit_levels}")
    check(launches["encode_slots"] == 0, "the training path launches no serving kernel")
    cv_values = [v for e in summary.validation_results for v in e.metric_values]
    check(len(summary.validation_results) == 11
          and len(cv_values) == DEFAULT_FOLD_MODELS, "33 fold-models")
    pos_rate = float(y.mean())
    for e in summary.validation_results:
        check(all(np.isfinite(v) and v > pos_rate for v in e.metric_values),
              f"{e.model_name} {e.grid} CV auPR {e.metric_values} finite and "
              f"above the positive rate {pos_rate}")
    # save -> load -> score on the card, equal to the in-memory model
    n_score = 1024
    feats = Dataset({"features": Column.vector(x[:n_score])})
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        model.save(tmp)
        loaded = WorkflowModel.load(tmp)
        save_load_s = time.perf_counter() - t1
        got = loaded.score(feats, device=dev)[pred.name]
    mem = model.score(feats, device=dev)[pred.name]
    check(got.data.shape[0] == n_score and np.isfinite(got.data).all()
          and got.data.tobytes() == mem.data.tobytes(),
          "the loaded model scores 1024 rows on the card equal to the in-memory model")
    full = Dataset({"label": Column(RealNN, y.astype(np.float64),
                                    np.ones(len(y), dtype=np.bool_)),
                    "features": Column.vector(x)})
    t1 = time.perf_counter()
    metrics = loaded.evaluate(Evaluators.binary_classification(), full, device=dev)
    eval_s = time.perf_counter() - t1
    eval_dev = max(abs(metrics[k] - v) for k, v in summary.train_evaluation.items())
    check(eval_dev <= 1e-6, f"evaluate {metrics} == the recorded train metrics "
                            f"{summary.train_evaluation} (|diff| {eval_dev})")
    out = {"rows": FULL_ROWS, "features": D, "fold_models": len(cv_values),
           "train_seconds": seconds, "fold_models_per_s": len(cv_values) / seconds,
           "synth_seconds_host": data_s,
           "phase_seconds": selector.last_fit_profile,
           "winner": summary.best_model_name, "winner_grid": summary.best_grid,
           "winner_model": type(win).__name__,
           "cv": [{"model": e.model_name, "grid": e.grid,
                   "values": e.metric_values, "mean": e.mean_metric}
                  for e in summary.validation_results],
           "positive_rate": pos_rate,
           "train_evaluation": summary.train_evaluation,
           "evaluate_max_abs_dev": eval_dev, "evaluate_seconds": eval_s,
           "save_load_seconds": save_load_s,
           "launches": launches, "expected_tree_launches": expected,
           "max_memory_allocated_bytes": peak, "score_rows": n_score}
    emit({"phase": "training_default", **out})
    return out


def _train_raw(torch, n: int, dev, seed: int = 0):
    """The serving_wide pipeline trained from raw columns through the port's
    entry points: ``make_data`` (tests/torch_wide_data.py) -> typed columns
    -> transmogrify -> sanity_check -> a 2-fold CV LogisticRegression
    selector -> Workflow.train on ``dev``.  Returns (model, workflow,
    pipeline handles, dataset, host seconds of the data, train seconds)."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import FIXTURE_SHAPE, make_data, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name

    t0 = time.perf_counter()
    cols, schema = make_data(n, seed=seed, **FIXTURE_SHAPE)
    t1 = time.perf_counter()
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    t2 = time.perf_counter()
    del cols
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    _sync(torch, dev)
    t3 = time.perf_counter()
    model = wf.train(device=dev)
    _sync(torch, dev)
    seconds = time.perf_counter() - t3
    handles = {"label": label, "sel": sel, "chk": chk, "pred": pred}
    return model, wf, handles, ds, {"make_data_s": t1 - t0,
                                    "from_features_s": t2 - t1}, seconds


def _fitted_by(model, cls: str) -> dict:
    """Fitted stages of class ``cls`` keyed by their inputs' names."""
    return {tuple(f.name for f in t.inputs): t for t in model.fitted.values()
            if type(t).__name__ == cls}


def _flush_operands(model, handles, ds, dev):
    """The training flush the checker waits for, rebuilt from the fitted
    model: its plan over ``ds`` on ``dev`` and the encode group's operands
    placed there."""
    from transmogrifai_tpu_torch.workflow.dag import compute_dag
    from transmogrifai_tpu_torch.workflow.plan import ColumnarTransformPlan

    vec = handles["chk"].inputs[1]
    runners = [model.fitted.get(s.uid, s) for layer in compute_dag([vec])
               for s in layer]
    plan = ColumnarTransformPlan(runners, frozenset(ds.names), dev)
    ops, _ = plan._place(plan._host_entries(ds), ds.n_rows)
    return plan, [ops[i] for i in plan._encode_inputs]


def phase_training_raw(torch, KE, dev) -> dict:
    """The wide pipeline trained from raw columns on the card: (a) at the
    committed fixture's 20 000 rows against that fixture; (b) the training
    flush's encode launch bitwise against its plain version, and timed at
    RAW_ROWS; (c) Workflow.train at RAW_ROWS by part."""
    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel

    # (a) parity with the fixture the JAX package trained
    fixture = WorkflowModel.load(FIXTURE)
    KE.reset_launch_counts()
    model, wf, h, ds, _, seconds_a = _train_raw(torch, FIXTURE_ROWS, dev)
    launches_a = KE.launch_counts()
    for cls, attr in (("NumericVectorizerModel", "fills"),
                      ("OneHotVectorizerModel", "vocabs"),
                      ("DecisionTreeNumericBucketizerModel", "splits"),
                      ("SanityCheckerModel", "kept_indices")):
        got, want = _fitted_by(model, cls), _fitted_by(fixture, cls)
        check(len(got) == len(want) >= 1, f"{cls}: {len(got)} fitted, fixture {len(want)}")
        # keyed by input names; the checker's input is named by stage uids
        check(got.keys() == want.keys() or cls == "SanityCheckerModel",
              f"{cls} inputs {sorted(got)} == the fixture's")
        for (k, a), b in zip(sorted(got.items()), [want[k] for k in sorted(want)]):
            x, y = getattr(a, attr), getattr(b, attr)
            check(np.array_equal(x, y) if attr == "fills" else x == y,
                  f"{cls} {k[:2]} {attr} equal to the fixture")
    [want_sel] = [t for t in fixture.fitted.values()
                  if type(getattr(t, "summary", None)).__name__ == "ModelSelectorSummary"]
    got_sel = model.fitted[h["sel"].uid]
    gs, ws = got_sel.summary, want_sel.summary
    check((gs.best_model_name, gs.best_grid) == (ws.best_model_name, ws.best_grid),
          f"winner {gs.best_model_name} {gs.best_grid} == fixture "
          f"{ws.best_model_name} {ws.best_grid}")
    check([e.grid for e in gs.validation_results] == [e.grid for e in ws.validation_results],
          "the grid equal to the fixture's")
    cv_dev = max(float(np.max(np.abs(np.asarray(a.metric_values) - np.asarray(b.metric_values))))
                 for a, b in zip(gs.validation_results, ws.validation_results))
    check(cv_dev <= 1e-4, f"LR CV metrics within 1e-4 of the fixture ({cv_dev})")
    coef, want_coef = np.asarray(got_sel.model.coef), np.asarray(want_sel.model.coef)
    coef_dev = float(np.max(np.abs(coef - want_coef)))
    check(np.allclose(coef, want_coef, rtol=1e-4, atol=1e-5)
          and np.isclose(got_sel.model.intercept, want_sel.model.intercept,
                         rtol=1e-4, atol=1e-5),
          f"LR coefficients within rtol 1e-4 / atol 1e-5 of the fixture ({coef_dev})")
    check(launches_a["encode_slots"] == 1 and launches_a["encode_slots.slots"] == 40
          and launches_a["onehot_codes"] == launches_a["bucketize_right_encode"] == 0,
          f"one encode launch of 40 slots over the whole table: {launches_a}")
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    recs = make_records(schema, BATCH, np.random.default_rng(3))
    pred_name = h["pred"].name
    fx_pred = next(f.name for f in fixture.result_features
                   if f.ftype.__name__ == "Prediction")
    got_p = [r[pred_name]["probability_1"] for r in model.serving_plan(device=dev).score(recs)]
    want_p = [r[fx_pred]["probability_1"] for r in fixture.serving_plan(device=dev).score(recs)]
    score_dev = float(np.max(np.abs(np.asarray(got_p) - np.asarray(want_p))))
    check(score_dev <= 1e-5, f"1024 requests scored within 1e-5 of the fixture ({score_dev})")

    # (b) the flush's encode launch at 20 000 rows, bitwise; the whole
    # flush on the card bitwise against the plain path on the CPU
    plan, ins = _flush_operands(model, h, ds, dev)
    table = plan._encode_table
    got = KE.encode_slots(ins, table)
    ref = KE.encode_slots_torch(ins, table)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"the flush's encode launch bitwise at {FIXTURE_ROWS} rows")
    vec = h["chk"].inputs[1]
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    card_vec = transform_dag(ds, [vec], model.fitted, dev)[vec.name].data
    cpu_vec = transform_dag(ds, [vec], model.fitted, torch.device("cpu"))[vec.name].data
    check(card_vec.shape == (FIXTURE_ROWS, 866) and card_vec.tobytes() == cpu_vec.tobytes(),
          "the training vector on the card bitwise the plain path's")
    del plan, ins, got, ref, ds, card_vec, cpu_vec

    # (c) Workflow.train at RAW_ROWS by part
    torch.cuda.reset_peak_memory_stats()
    KE.reset_launch_counts()
    model, wf, h, ds, data_s, seconds = _train_raw(torch, RAW_ROWS, dev)
    launches = KE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches["encode_slots"] >= 1 and launches["onehot_codes"] == 0
          and launches["bucketize_right_encode"] == 0,
          f"the training path launches the encode kernel: {launches}")
    prof = wf.last_train_profile
    fits = [r for r in prof if r["kind"] == "fit"]
    flushes = [r for r in prof if r["kind"] == "flush"]
    enc_flushes = [r for r in flushes if r.get("encode_slots")]
    check(len(enc_flushes) == 1 and enc_flushes[0]["rows"] == RAW_ROWS
          and enc_flushes[0]["encode_slots"] == 40
          and launches["encode_slots"] == 1,
          f"one flush encodes all 40 slots of {RAW_ROWS} rows in one launch: {flushes}")
    summary = model.fitted[h["sel"].uid].summary
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")
    by_stage = {}
    for r in fits:
        by_stage[r["stage"]] = by_stage.get(r["stage"], 0.0) + r["seconds"]
    stage_fits = sum(v for k, v in by_stage.items()
                     if k not in ("SanityChecker", "ModelSelector"))

    # the flush's encode launch at RAW_ROWS: bitwise, then timed
    plan, ins = _flush_operands(model, h, ds, dev)
    table = plan._encode_table
    width = table.width
    buf = torch.empty((RAW_ROWS, -(-width // 4) * 4), device=dev)[:, :width]
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          f"the flush's encode launch bitwise at {RAW_ROWS} rows")
    nbytes = (sum(x.numel() * x.element_size() for x in ins) + table.splits.nbytes
              + RAW_ROWS * width * 4)
    enc = {"rows": RAW_ROWS, "slots": len(table), "columns": width,
           "chunks": len(table.chunks),
           "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
           "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None,
           "in_flush_ms": enc_flushes[0]["encode_ms"], "max_abs_err": 0.0}
    del plan, ins, buf
    out = {"rows": RAW_ROWS, "train_seconds": seconds,
           "data_host_seconds": data_s,
           "parts_seconds": {
               "stage_fits_host": stage_fits,
               "flushes": [{k: r.get(k) for k in (
                   "seconds", "stages", "encode_slots", "host_encode_s", "h2d_s",
                   "device_s", "encode_ms", "d2h_s", "columns_s", "host_stages_s",
                   "h2d_copies", "d2h_copies", "h2d_bytes", "d2h_bytes")}
                   for r in flushes],
               "sanity_checker": by_stage.get("SanityChecker"),
               "sanity_checker_parts": h["chk"].last_fit_profile,
               "selector": by_stage.get("ModelSelector"),
               "selector_parts": h["sel"].last_fit_profile},
           "fit_seconds_by_stage": by_stage,
           "launches": launches,
           "h2d_copies": sum(r.get("h2d_copies", 0) for r in flushes),
           "d2h_copies": sum(r.get("d2h_copies", 0) for r in flushes),
           "max_memory_allocated_bytes": peak,
           "winner": summary.best_model_name, "winner_grid": summary.best_grid,
           "cv": [{"grid": e.grid, "values": e.metric_values}
                  for e in summary.validation_results],
           "kept": len(model.fitted[h["chk"].uid].kept_indices),
           "encode_at_rows": enc,
           "parity_20000": {"train_seconds": seconds_a, "cv_max_abs_dev": cv_dev,
                            "coef_max_abs_dev": coef_dev,
                            "score_max_abs_dev": score_dev,
                            "launches": launches_a}}
    emit({"phase": "training_raw", **out})
    return out


# -- the families: text, dates, lists, multi-pick lists, geolocations -------------

def _families_train(torch, n: int, dev):
    """The families pipeline (tests/torch_families_data.py) trained from raw
    columns on ``dev`` through the port's entry points.  Returns (model,
    workflow, pipeline handles, dataset, columns, host seconds of the data,
    train seconds)."""
    import transmogrifai_tpu_torch as T
    from torch_families_data import families_pipeline, make_families
    from transmogrifai_tpu_torch.types import feature_type_by_name

    t0 = time.perf_counter()
    cols, schema = make_families(n, seed=0)
    t1 = time.perf_counter()
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    t2 = time.perf_counter()
    label, sel, chk, pred = families_pipeline(T, ftypes, schema)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    _sync(torch, dev)
    t3 = time.perf_counter()
    model = wf.train(device=dev)
    _sync(torch, dev)
    seconds = time.perf_counter() - t3
    handles = {"label": label, "sel": sel, "chk": chk, "pred": pred}
    return model, wf, handles, ds, cols, {"make_families_s": t1 - t0,
                                          "from_features_s": t2 - t1}, seconds


def _no_python_hashing(native, what: str) -> dict:
    counts = native.path_counts()
    check(not [k for k in counts if k.endswith(".python")],
          f"{what}: every hashing call took the native library: {counts}")
    return counts


def phase_families(torch, KE, dev) -> dict:
    """transmogrify's text, date, list, multi-pick and geolocation families
    on the card: (a) the native hashing library builds here and equals its
    Python path; (b) the 4096-row train against the JAX package's record
    (fixtures/training_families); (c) Workflow.train at FAMILY_ROWS by part;
    (d) save -> load -> serving_plan() over 16 batches of 1024 records, equal
    to the CPU plan's; (e) model.serve() answering 2048 one-record requests."""
    import numpy as np

    from torch_families_data import fitted_states, make_records, vector_digest
    from transmogrifai_tpu_torch import WorkflowModel, native
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    # (a) the g++ build, and its blocks against the Python path's
    t0 = time.perf_counter()
    check(native.warmup(), f"the native hashing library built: {native.BUILD_ERROR}")
    build = {"seconds": time.perf_counter() - t0, **native.BUILD_INFO}
    sample = ["Café crème, naïve résumé", "東京の美味しいラーメン屋さん 2024", "plain ascii text 42",
              "Straße über Ärger", "", None, "x" * 5000 + " tail", "Ελληνικά и русский"] * 300
    docs = [t.split() if t else None for t in sample]
    native.reset_path_counts()
    nat = (native.tokenize_hash_count(sample, 512), native.hash_count_block(docs, 512))
    _no_python_hashing(native, "the Unicode sample")
    saved = native._LIB
    try:
        native._LIB = None
        py = (native.tokenize_hash_count(sample, 512), native.hash_count_block(docs, 512))
    finally:
        native._LIB = saved
    check(nat[0][0].tobytes() == py[0][0].tobytes() and nat[0][1].tobytes() == py[0][1].tobytes()
          and nat[1].tobytes() == py[1].tobytes(),
          "native hashing blocks bitwise the Python path's on a Unicode sample")

    # (b) parity at the record's size
    with open(os.path.join(FAMILIES_FIXTURE, "states.json")) as fh:
        states = json.load(fh)
    with open(os.path.join(FAMILIES_FIXTURE, "records.json")) as fh:
        recorded = json.load(fh)
    native.reset_path_counts()
    KE.reset_launch_counts()
    model, wf, h, ds, _, _, seconds_b = _families_train(torch, states["rows"], dev)
    launches_b = KE.launch_counts()
    _no_python_hashing(native, "the 4096-row train")
    check(json.loads(json.dumps(fitted_states(model))) == states["fitted"],
          "fitted states (SmartText decisions, vocabularies, fills, kept indices) "
          "== the JAX record")
    vec = h["chk"].inputs[1]
    got_vec = transform_dag(ds, [vec], model.fitted, dev)[vec.name].data
    check(vector_digest(got_vec) == states["vector"],
          f"the training vector on the card bitwise the JAX record's {states['vector']}")
    summary = model.fitted[h["sel"].uid].summary
    cv_dev = max(abs(a - b) for e, c in zip(summary.validation_results, states["cv"])
                 for a, b in zip(e.metric_values, c["values"]))
    check(cv_dev <= 1e-4, f"LR CV metrics within 1e-4 of the JAX record ({cv_dev})")
    win = model.fitted[h["sel"].uid].model
    coef_dev = float(np.max(np.abs(np.asarray(win.coef) - np.asarray(states["winner"]["coef"]))))
    check(summary.best_grid == states["winner"]["grid"]
          and np.allclose(win.coef, states["winner"]["coef"], rtol=1e-4, atol=1e-5),
          f"the winner and its coefficients within rtol 1e-4 / atol 1e-5 ({coef_dev})")
    check(launches_b["encode_slots"] == 1 and launches_b["encode_slots.slots"] == 2,
          f"the pick lists' 2 slots in one encode launch: {launches_b}")
    fixture = WorkflowModel.load(FAMILIES_FIXTURE)
    fplan, fcpu = fixture.serving_plan(), fixture.serving_plan(device="cpu")
    pname = recorded["prediction"]
    rec_dev = 0.0
    for b in recorded["batches"]:
        got = fplan.score(b["records"])
        check(got == fcpu.score(b["records"]), "the JAX-saved model: card records == CPU plan's")
        rec_dev = max([rec_dev] + [abs(g[pname]["probability_1"] - w[pname]["probability_1"])
                                   for g, w in zip(got, b["scored"])])
    check(rec_dev <= 1e-12, f"the JAX-saved model's records within 1e-12 of the JAX "
                            f"plan's ({rec_dev})")
    del model, wf, h, ds, got_vec, fixture, fplan, fcpu

    # (c) Workflow.train at FAMILY_ROWS by part
    torch.cuda.reset_peak_memory_stats()
    KE.reset_launch_counts()
    native.reset_path_counts()
    model, wf, h, ds, cols, data_s, seconds = _families_train(torch, FAMILY_ROWS, dev)
    launches = KE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    paths = _no_python_hashing(native, f"the {FAMILY_ROWS}-row train")
    check(launches["encode_slots"] == 1 and launches["encode_slots.slots"] == 2
          and launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"the training path launches the encode kernel once with 2 slots: {launches}")
    prof = wf.last_train_profile
    fits = [r for r in prof if r["kind"] == "fit"]
    flushes = [r for r in prof if r["kind"] == "flush"]
    by_stage: dict = {}
    for r in fits:
        by_stage[r["stage"]] = by_stage.get(r["stage"], 0.0) + r["seconds"]
    host_by_stage: dict = {}
    for r in flushes:
        for k, v in (r.get("host_stage_seconds") or {}).items():
            host_by_stage[k] = host_by_stage.get(k, 0.0) + v
    hashing = sum(host_by_stage.get(k, 0.0) for k in ("SmartTextVectorizerModel",
                                                        "TextListHashingVectorizer"))
    summary = model.fitted[h["sel"].uid].summary
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")
    # the flush's encode launch at FAMILY_ROWS, bitwise, then timed
    plan, ins = _flush_operands(model, h, ds, dev)
    table = plan._encode_table
    enc_w = table.width
    buf = torch.empty((FAMILY_ROWS, -(-enc_w // 4) * 4), device=dev)[:, :enc_w]
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          f"the families flush's encode launch bitwise at {FAMILY_ROWS} rows")
    nbytes = (sum(x.numel() * x.element_size() for x in ins) + table.splits.nbytes
              + FAMILY_ROWS * enc_w * 4)
    enc = {"rows": FAMILY_ROWS, "slots": len(table), "columns": enc_w,
           "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
           "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": time_big_ms(lambda: torch.cat(
               [torch.nn.functional.one_hot(x.long(), sp.width).float()
                for x, sp in zip(ins, table.specs)], 1), runs=5),
           "library": "torch.nn.functional.one_hot(codes, width).float() per slot, "
                      "then torch.cat (this run's codes all lie in range)",
           "max_abs_err": 0.0}
    del plan, ins, buf
    vec_width = int(transform_dag(ds.take(np.arange(8)), [h["chk"].inputs[1]], model.fitted,
                                  dev)[h["chk"].inputs[1].name].data.shape[1])

    # (d) save -> load -> the serving plan on the card, 16 batches of 1024
    path = os.path.join("build", "families_model")
    model.save(path)
    loaded = WorkflowModel.load(path)
    splan, scpu = loaded.serving_plan(), loaded.serving_plan(device="cpu")
    batches = [make_records(cols, range(i * BATCH, (i + 1) * BATCH)) for i in range(N_BATCHES)]
    check(splan.score(batches[0]) == model.serving_plan().score(batches[0]),
          "the loaded model serves the records the trained one does")
    torch.cuda.synchronize()
    KE.reset_launch_counts()
    native.reset_path_counts()
    rows, parts = [], []
    t0 = time.perf_counter()
    for b in batches:
        rows.append(splan.score(b))
        parts.append(dict(splan.last_timings))
    wall = time.perf_counter() - t0
    launches_serving = KE.launch_counts()
    serve_paths = native.path_counts()
    check(launches_serving["encode_slots"] == N_BATCHES
          and launches_serving["encode_slots.slots"] == 2 * N_BATCHES,
          f"one encode launch of 2 slots per batch: {launches_serving}")
    for b, got in zip(batches, rows):
        check(got == scpu.score(b), "card records == CPU plan records")
    host_classes = sorted({type(r).__name__ for r in splan._remainder})
    check({"VectorsCombiner", "SanityCheckerModel", "SmartTextVectorizerModel"}
          <= set(host_classes), f"the combiner, checker and SmartText on the host: "
                                f"{host_classes}")

    def med(key):
        return statistics.median(p[key] for p in parts)

    # (e) model.serve(): 2048 one-record requests
    records = [r for b in batches[:2] for r in b]
    server = loaded.serve()
    try:
        seen = _capture_batches(server.plan)
        KE.reset_launch_counts()
        pairs, swall = _drive_clients(server, records, CLIENTS, CLIENT_WINDOW)
        launches_server = KE.launch_counts()
        bat = server.batcher.metrics()
    finally:
        server.close()
    check(bat["completed"] == len(records) and bat["failed"] == 0,
          f"every request completed: {bat}")
    want = _expected(scpu, seen)
    check(all(f.result() == want[id(r)] for r, f in pairs),
          "every served record == the plan's record for its batch")
    check(launches_server["encode_slots"] == bat["batches"],
          f"one encode launch per flushed batch: {launches_server} {bat['batches']}")
    out = {"rows": FAMILY_ROWS, "train_seconds": seconds, "data_host_seconds": data_s,
           "native_build": build, "hash_paths": paths, "vector_width": vec_width,
           "parts_seconds": {
               "stage_fits_host": sum(v for k, v in by_stage.items() if k not in (
                   "SanityChecker", "ModelSelector", "SmartTextVectorizer")),
               "smart_text_fit": by_stage.get("SmartTextVectorizer"),
               "hash_transforms": hashing,
               "flushes": sum(r["seconds"] for r in flushes),
               "flush_parts": [{k: r.get(k) for k in (
                   "seconds", "stages", "encode_slots", "host_encode_s", "h2d_s",
                   "device_s", "encode_ms", "d2h_s", "columns_s", "host_stages_s",
                   "host_stage_seconds", "h2d_bytes", "d2h_bytes")} for r in flushes],
               "sanity_checker": by_stage.get("SanityChecker"),
               "selector": by_stage.get("ModelSelector")},
           "fit_seconds_by_stage": by_stage,
           "launches": launches, "max_memory_allocated_bytes": peak,
           "kept": len(model.fitted[h["chk"].uid].kept_indices),
           "winner": summary.best_model_name, "winner_grid": summary.best_grid,
           "cv": [{"grid": e.grid, "values": e.metric_values}
                  for e in summary.validation_results],
           "encode_at_rows": enc,
           "serving": {"batches": N_BATCHES, "batch": BATCH,
                       "records_per_s": N_BATCHES * BATCH / wall,
                       "encode_ms_median": med("encode_ms"),
                       "device_ms_median": med("device_ms"),
                       "host_ms_median": med("host_ms"),
                       "launches": launches_serving, "hash_paths": serve_paths,
                       "host_stages": host_classes, "records_equal_cpu": True},
           "server": {"records": len(records), "records_per_s": len(records) / swall,
                      "batches": bat["batches"], "latency_p50_ms": bat["latency_p50_ms"],
                      "latency_p99_ms": bat["latency_p99_ms"],
                      "launches": launches_server["encode_slots"],
                      "records_equal_plan": True},
           "parity_4096": {"train_seconds": seconds_b, "cv_max_abs_dev": cv_dev,
                           "coef_max_abs_dev": coef_dev, "record_max_abs_dev": rec_dev,
                           "launches": launches_b}}
    emit({"phase": "families", **out})
    return out


# -- regression and multiclass selection ------------------------------------------

def train_problem(torch, x, y, dev, selector):
    """The port's user entry points with ``selector``: FeatureBuilder ->
    label.transform_with(selector, vector) -> Workflow.train on ``dev``.
    Returns (WorkflowModel, prediction feature, train seconds)."""
    import numpy as np

    from transmogrifai_tpu_torch import FeatureBuilder, Workflow
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.types import RealNN

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
    pred = label.transform_with(selector, vec)
    ds = Dataset({"label": Column(RealNN, y.astype(np.float64),
                                  np.ones(len(y), dtype=np.bool_)),
                  "features": Column.vector(x)})
    _sync(torch, dev)
    t0 = time.perf_counter()
    model = Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device=dev)
    _sync(torch, dev)
    return model, pred, time.perf_counter() - t0


def _selector(classes, **kw):
    from transmogrifai_tpu_torch.models.selector import (
        MultiClassificationModelSelector,
        RegressionModelSelector,
    )

    cls = RegressionModelSelector if classes is None \
        else MultiClassificationModelSelector
    return cls.with_cross_validation(**kw)


def _refit_levels(win) -> int:
    """Grown levels of the winner's refit: none for a linear family."""
    if not hasattr(win, "trees"):
        return 0
    return win.max_depth * (win.n_trees if "GBT" in type(win).__name__ else 1)


def phase_selection_parity(torch, KE, dev) -> dict:
    """The default regression and multiclass selectors at 4096 rows x 16
    against the JAX package's record (fixtures/training_selection), the
    forests' draws fed from it, TF32 off: every (family, grid) CV metric
    within its family's tolerance, the reference's winner (or, where the
    reference's two best tie within that tolerance, one of them), the data
    prep equal and the winner's train metrics close.  The 30-class run
    tiles K1's channels."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(SELECTION_FIXTURE, "summary.json")) as fh:
        rec = json.load(fh)
    recipe = rec["recipe"]
    out = {}
    for name, run in rec["runs"].items():
        classes = run["classes"]
        x, y = selection_data(recipe["rows"], recipe["features"], classes,
                              recipe["data_seed"])
        selector = _selector(classes, num_folds=recipe["folds"],
                             seed=recipe["selector_seed"])
        _reset_all(KE)
        with FixtureDraws(torch, SELECTION_FIXTURE):
            model, _, seconds = train_problem(torch, x, y, dev, selector)
        launches = _all_counts(KE)
        summary = model.fitted[selector.uid].summary
        check([(e.model_name, e.grid) for e in summary.validation_results]
              == [(r["model"], r["grid"]) for r in run["validation"]],
              f"{name}: the reference's families and grids in its order")
        dev_max, ref_mean = {}, {}
        for e, r in zip(summary.validation_results, run["validation"]):
            rtol, atol = SELECTION_TOL[e.model_name]
            got, want = np.asarray(e.metric_values), np.asarray(r["values"])
            check(bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want))),
                  f"{name} {e.model_name} {e.grid} CV {got.tolist()} vs "
                  f"{want.tolist()} (rtol {rtol}, atol {atol})")
            dev_max[e.model_name] = max(dev_max.get(e.model_name, 0.0),
                                        float(np.max(np.abs(got - want))))
            ref_mean[(e.model_name, json.dumps(e.grid, sort_keys=True))] = float(want.mean())
        win = (summary.best_model_name, json.dumps(summary.best_grid, sort_keys=True))
        ref_win = (run["winner"]["name"], json.dumps(run["winner"]["grid"], sort_keys=True))
        rtol, atol = SELECTION_TOL[win[0]]
        gap = abs(ref_mean[win] - ref_mean[ref_win])
        check(win == ref_win or gap <= atol + rtol * abs(ref_mean[ref_win]),
              f"{name}: winner {win} is the reference's {ref_win} or ties it "
              f"within the tolerance (gap {gap})")
        check((summary.data_prep.kind, summary.data_prep.details)
              == (run["data_prep"]["kind"], run["data_prep"]["details"]),
              f"{name}: data prep {summary.data_prep} == the reference's")
        train_dev = None
        if win == ref_win:
            train_dev = max(abs(summary.train_evaluation[k] - v)
                            for k, v in run["train_evaluation"].items())
            check(train_dev <= (1e-4 if classes is None else 1e-3),
                  f"{name}: train metrics {summary.train_evaluation} vs "
                  f"{run['train_evaluation']}")
        if classes is not None and 2 * classes > 44:
            check(launches["hist_level.chan_tiled"] > 0,
                  f"{name}: K1 tiled the channels of {classes} classes")
        out[name] = {"seconds": seconds, "winner": summary.best_model_name,
                     "winner_grid": summary.best_grid, "winner_equal": win == ref_win,
                     "winner_gap": gap, "cv_max_abs_dev": dev_max,
                     "train_max_abs_dev": train_dev,
                     "launches": {k: v for k, v in launches.items() if v}}
    emit({"phase": "selection_parity", "rows": recipe["rows"],
          "features": recipe["features"], **out})
    return out


def _wide_hist_inputs(torch, dev, L: int, n: int, nn: int, classes: int,
                      int_exact: bool, seed: int):
    """A level of a ``classes``-class fit: half the rows are right children
    or leaf-stuck (node -1); grad/hess are fold weight x Poisson bootstrap x
    one-hot label (int8) for forests, softmax grad/hess (float) for GBT."""
    g = torch.Generator(device=dev).manual_seed(seed)
    binned = torch.randint(0, N_BINS + 1, (n, D), generator=g, device=dev,
                           dtype=torch.int32)
    node = torch.randint(0, 2 * nn, (L, n), generator=g, device=dev, dtype=torch.int32)
    local = torch.where(node % 2 == 0, node // 2, torch.full_like(node, -1))
    fold = torch.randint(0, FOLDS, (n,), generator=g, device=dev)
    w = (fold[None, :] != (torch.arange(L, device=dev) % FOLDS)[:, None]).float()
    y = torch.randint(0, classes, (n,), generator=g, device=dev)
    onehot = torch.nn.functional.one_hot(y, classes).T.float()       # (C, n)
    if int_exact:
        wt = w * torch.poisson(torch.ones((L, n), device=dev), generator=g)
        gh = torch.cat([-wt[:, None] * onehot[None],
                        wt[:, None].expand(L, classes, n)], dim=1)
        gh = gh.to(torch.int8).contiguous()
    else:
        p = torch.softmax(torch.randn((L, classes, n), generator=g, device=dev), dim=1)
        gh = torch.cat([w[:, None] * (p - onehot[None]),
                        w[:, None] * p * (1 - p)], dim=1).contiguous()
    return local.contiguous(), gh, binned


def phase_wide_label_kernels(torch, dev) -> dict:
    """K1 with 200 channels (100 classes) at WIDE_ROWS rows x 128: the int8
    path at 150 lanes x 16 nodes held bitwise, the float path at 3 lanes x 4
    nodes within f32_tolerance, both channel-tiled; forest regression's float
    K1 at 150 lanes x 16 nodes over 1 048 576 rows; K2 at K = 100 (unstaged)
    on the float level's histograms (float_agreement) and on integer-valued
    ones at 150 lanes x 2 nodes (bitwise).  Each timed beside its bound, its
    plain version and, for K1, index_add_ at a stated smaller row count."""
    KH, KS, _ = _tree_modules()
    out = {}
    for key, (L, nn, int_exact, seed) in (("int8", (FOLDS * 50, 16, True, 41)),
                                          ("f32", (FOLDS, 4, False, 42))):
        local, gh, binned = _wide_hist_inputs(torch, dev, L, WIDE_ROWS, nn,
                                              WIDE_CLASSES, int_exact, seed)
        p = KH.plan(L, WIDE_ROWS, D, nn, 2 * WIDE_CLASSES, N_BINS, int_exact)
        check(p["chan_tiles"] > 1, f"K1 {key} at 200 channels tiles them: {p}")
        e = _k1_level(torch, KH, bound, local, gh, binned, nn, False, int_exact)
        lib_rows = WIDE_LIBRARY_ROWS[int_exact]
        sl = (local[:, :lib_rows].contiguous(), gh[..., :lib_rows].contiguous(),
              binned[:lib_rows])
        call, _ = _index_add_library(torch, *sl, nn)
        e.update(library_rows=lib_rows, ms_at_library_rows=time_big_ms(
            lambda: KH.hist_level(*sl, nn, N_BINS, int_exact=int_exact)),
            library_ms=time_big_ms(call),
            library="index_add_ of the (lane, channel, row, feature) terms at "
                    "their flat index, float32 (a composite)")
        if not int_exact:
            hist = KH.hist_level(local, gh, binned, nn, N_BINS).reshape(
                L, nn, 2 * WIDE_CLASSES, N_BINS + 1, D).transpose(-1, -2)
        out[key] = e
        del sl, call, local, gh, binned
        torch.cuda.empty_cache()
    local, gh, binned = _hist_inputs(torch, dev, FOLDS * 50, FULL_ROWS, 16, False, 43)
    e = _k1_level(torch, KH, bound, local, gh, binned, 16, False, False)
    # its library call at INT8_LIBRARY_ROWS, as the int8 level's: the full
    # rows' index would not fit the card
    sl = (local[:, :INT8_LIBRARY_ROWS].contiguous(),
          gh[..., :INT8_LIBRARY_ROWS].contiguous(), binned[:INT8_LIBRARY_ROWS])
    call, _ = _index_add_library(torch, *sl, 16)
    e.update(library_rows=INT8_LIBRARY_ROWS, ms_at_library_rows=time_big_ms(
        lambda: KH.hist_level(*sl, 16, N_BINS)), library_ms=time_big_ms(call),
        library="index_add_ of the (lane, channel, row, feature) terms at their "
                "flat index, float32 (a composite)")
    out["forest_regression_f32"] = e
    del local, gh, binned, sl, call
    torch.cuda.empty_cache()

    K = WIDE_CLASSES
    hg, hh = hist[:, :, :K].contiguous(), hist[:, :, K:].contiguous()
    del hist
    g = torch.Generator(device=dev).manual_seed(44)
    shape = (FOLDS * 50, 2, K, D, N_BINS + 1)
    ig = torch.randint(-20, 20, shape, generator=g, device=dev).float()
    ih = torch.randint(0, 30, shape, generator=g, device=dev).float()
    k2 = {}
    for key, (a, b, params) in (("gbt_level", (hg, hh, (1.0, 0.0, 0.0, 1.0))),
                                ("rf_level", (ig, ih, (0.0, 0.0, 0.0, 1.0)))):
        G = a[:, :, :, 0, :].sum(-1).contiguous()
        H = b[:, :, :, 0, :].sum(-1).contiguous()
        args = (a, b, G, H, torch.ones((a.shape[0], D), device=dev), N_BINS, *params)
        L, nn = a.shape[:2]
        p = KS.plan(L, nn, K, D, N_BINS)
        check(not p.staged, f"K2 at K = {K} reads its histograms where they lie")
        run = lambda: KS.split_scan(*args)  # noqa: E731
        got, again = run(), run()
        _sync(torch, dev)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"K2 at K = {K} bitwise run to run ({key})")
        e = {"shape": [L, nn, K, D, N_BINS + 1], "ms": time_device_ms(run),
             **bound(KS.bound_bytes(L, nn, K, D, N_BINS),
                     KS.bound_ops(L, nn, K, D, N_BINS)),
             "plan": p._asdict(), "library_ms": None, "library": None}
        e["plain_ms"], ref = time_once(lambda: KS.split_scan_torch(*args))
        if key == "gbt_level":
            agree = KS.float_agreement(got, *args)
            check(agree["ok"], f"K2 at K = {K} within tolerance: {agree}")
            e["agreement"] = agree
            e["max_abs_err"] = agree["max_abs_err"]
        else:
            check(all(torch.equal(u, v) for u, v in zip(got, ref)),
                  f"K2 at K = {K} bitwise to the plain version")
            e["max_abs_err"] = 0.0
        k2[key] = e
        del args, got, again, ref
    out["split_scan_k100"] = k2
    del hg, hh, ig, ih
    torch.cuda.empty_cache()
    emit({"phase": "wide_label_kernels", **out})
    return out


def _train_full(torch, KE, dev, x, y, classes, expected_cv_levels: int,
                fold_models: int) -> dict:
    """The default selector of ``classes`` (None: regression) over (x, y)
    through Workflow.train on the card, the counters zeroed just before and
    read just after: K1-K3 launch once per grown level (CV, then the
    winner's refit); every CV metric finite; model.score of 1024 rows finite."""
    import numpy as np

    from transmogrifai_tpu_torch.data.dataset import Column, Dataset

    torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    selector = _selector(classes, num_folds=FOLDS, seed=SELECTOR_SEED)
    model, pred, seconds = train_problem(torch, x, y, dev, selector)
    launches = _all_counts(KE)
    peak = torch.cuda.max_memory_allocated()
    fitted = model.fitted[selector.uid]
    summary = fitted.summary
    expected = expected_cv_levels + _refit_levels(fitted.model)
    for k in ("hist_level", "split_scan", "row_select_lanes"):
        check(launches[k] == expected,
              f"{k} launched {launches[k]} times, expected {expected}")
    check(launches["encode_slots"] == 0, "the training path launches no serving kernel")
    values = [v for e in summary.validation_results for v in e.metric_values]
    check(len(values) == fold_models and all(np.isfinite(values)),
          f"{fold_models} finite fold-model metrics: {len(values)}")
    scored = model.score(Dataset({"features": Column.vector(x[:1024])}),
                         device=None if dev.type == "cuda" else dev)[pred.name]
    check(scored.data.shape[0] == 1024 and np.isfinite(scored.data).all(),
          "model.score of 1024 rows on the card is finite")
    profile = selector.last_fit_profile
    return {"rows": len(y), "features": int(x.shape[1]), "classes": classes,
            "fold_models": fold_models, "train_seconds": seconds,
            "fold_models_per_s": fold_models / seconds,
            "phase_seconds": profile,
            "family_seconds": {k[3:]: v for k, v in profile.items()
                               if k.startswith("cv.")},
            "winner": summary.best_model_name, "winner_grid": summary.best_grid,
            "winner_model": type(fitted.model).__name__,
            "cv": [{"model": e.model_name, "grid": e.grid, "mean": e.mean_metric}
                   for e in summary.validation_results],
            "train_evaluation": {k: v for k, v in summary.train_evaluation.items()
                                 if k != "confusion"},
            "data_prep": vars(summary.data_prep),
            "launches": launches, "expected_tree_launches": expected,
            "max_memory_allocated_bytes": peak}


def phase_training_regression(torch, KE, dev) -> dict:
    """RegressionModelSelector.with_cross_validation() (its default families:
    33 fold-models) at bench.py's 1 048 576 x 128 with a real label from
    numpy seed 0."""
    x, _ = synth(FULL_ROWS, D, 0)
    y = regression_label(x, 0)
    out = _train_full(torch, KE, dev, x, y, None, REGRESSION_CV_LEVELS,
                      REGRESSION_FOLD_MODELS)
    out["label_std"] = float(y.std())
    check(out["winner"] and min(e["mean"] for e in out["cv"]) < out["label_std"],
          "the winner's CV rmse is below the label's spread")
    emit({"phase": "training_regression", **out})
    return out


def phase_training_multiclass(torch, KE, dev) -> dict:
    """MultiClassificationModelSelector.with_cross_validation() (its default
    families behind a DataCutter: 24 fold-models) at 1 048 576 x 128 with
    MC_CLASSES classes; then once at WIDE_ROWS x 128 with WIDE_CLASSES
    classes, where K1 tiles the channels and K2 reads unstaged."""
    x, _ = synth(FULL_ROWS, D, 0)
    y = multiclass_label(x, MC_CLASSES, 0)
    out = _train_full(torch, KE, dev, x, y, MC_CLASSES, MULTICLASS_CV_LEVELS,
                      MULTICLASS_FOLD_MODELS)
    check(out["data_prep"]["details"]["labelsKept"] == list(map(float, range(MC_CLASSES))),
          "the DataCutter keeps every class")
    check(min(e["mean"] for e in out["cv"]) < 1.0 - 1.0 / MC_CLASSES,
          "the winner's CV error is below chance")
    del x, y
    x, _ = synth(WIDE_ROWS, D, 1)
    y = multiclass_label(x, WIDE_CLASSES, 1)
    wide = _train_full(torch, KE, dev, x, y, WIDE_CLASSES, MULTICLASS_CV_LEVELS,
                       MULTICLASS_FOLD_MODELS)
    check(wide["launches"]["hist_level.chan_tiled"] > 0
          and wide["launches"]["split_scan.unstaged"] > 0,
          f"100 classes: K1 tiled its channels and K2 read unstaged: {wide['launches']}")
    check(len(wide["data_prep"]["details"]["labelsKept"]) == WIDE_CLASSES,
          "the DataCutter keeps 100 classes")
    out["wide"] = wide
    emit({"phase": "training_multiclass", **out})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(1, os.path.join(here, "tests"))  # torch_encode_cases
    os.chdir(here)
    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.ops.bucketizers import DecisionTreeNumericBucketizerModel
    from transmogrifai_tpu_torch.ops.onehot import OneHotVectorizerModel
    from transmogrifai_tpu_torch.perf.kernels import dispatch
    from transmogrifai_tpu_torch.perf.kernels import encode as KE

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    dispatch.build(["encode", "trees"])
    KE._lib()
    for m in _tree_modules():
        m._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          **{f"{lib}_nvcc_seconds": dispatch.BUILD_INFO[lib]["seconds"]
             for lib in ("encode", "trees")},
          "ptxas": {lib: [ln for ln in str(dispatch.BUILD_INFO[lib]["log"]).splitlines()
                          if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
                    for lib in ("encode", "trees")}})

    # 3. kernels
    model = WorkflowModel.load(FIXTURE)
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    buckets = [t for t in model.fitted.values()
               if isinstance(t, DecisionTreeNumericBucketizerModel) and t.should_split]
    check(len(buckets) > 0, "fixture has a bucketizer with real splits")
    timings = phase_kernels(torch, KE, buckets, dev)
    plan = model.serving_plan()
    check(plan.device.type == "cuda", "serving_plan() defaults to the card")
    fused = phase_fused(torch, KE, plan._encode_table, dev)

    # 4. serving
    cpu_plan = model.serving_plan(device="cpu")
    onehot_slots = sum(len(r.vocabs) for r in plan._prefix
                       if isinstance(r, OneHotVectorizerModel))
    bucket_slots = sum(1 for r in plan._prefix
                       if isinstance(r, DecisionTreeNumericBucketizerModel)
                       and r.should_split)
    check(len(plan._encode_table) == onehot_slots + bucket_slots,
          "the plan's slot table holds every one-hot and bucketize slot")
    rng = np.random.default_rng(1)
    batches = [make_records(schema, BATCH, rng) for _ in range(N_BATCHES)]
    batches.append(make_records(schema, RAGGED, rng))
    plan.score(make_records(schema, BATCH, rng))   # warm-up (allocator, consts)
    torch.cuda.synchronize()

    KE.reset_launch_counts()
    copies0 = plan.metrics()["h2d_copies"]
    rows, parts = [], []
    t0 = time.perf_counter()
    for b in batches[:N_BATCHES]:
        rows.append(plan.score(b))
        parts.append(dict(plan.last_timings))
    wall_full = time.perf_counter() - t0
    rows.append(plan.score(batches[-1]))
    parts.append(dict(plan.last_timings))
    launches = KE.launch_counts()
    copies = plan.metrics()["h2d_copies"] - copies0

    n_batches = len(batches)
    check(launches["encode_slots"] == n_batches,
          f"encode launches {launches['encode_slots']} == one per batch ({n_batches})")
    check(launches["encode_slots.slots"] == n_batches * (onehot_slots + bucket_slots)
          and onehot_slots > 0 and bucket_slots > 0,
          f"slots encoded {launches['encode_slots.slots']} == {n_batches} x "
          f"({onehot_slots} + {bucket_slots})")
    check(launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"no one-slot launch on the serving path: {launches}")
    check(copies == 2 * n_batches,
          f"host->device copies {copies} == 2 per batch ({n_batches} batches)")

    pred_name = next(f.name for f in model.result_features
                     if f.ftype.__name__ == "Prediction")
    for b, got in zip(batches, rows):
        check(len(got) == len(b), "one output record per request")
        for r in got:
            p = r[pred_name]
            check(all(np.isfinite(v) for v in p.values())
                  and 0.0 <= p["probability_1"] <= 1.0, f"finite prediction {p}")
        check(cpu_plan.score(b) == got, "card records == CPU plan records")
        dev_vec = plan.prefix_outputs(b)
        cpu_vec = cpu_plan.prefix_outputs(b)
        check(all(a.shape == c.shape and a.dtype == c.dtype
                  and a.tobytes() == c.tobytes() for a, c in zip(dev_vec, cpu_vec)),
              "prefix vectors bitwise equal on card and CPU")

    def med(key):
        return statistics.median(p[key] for p in parts[:N_BATCHES])

    emit({"phase": "serving", "batches": n_batches, "batch": BATCH,
          "ragged": RAGGED, "records_per_s": N_BATCHES * BATCH / wall_full,
          "encode_ms_median": med("encode_ms"),
          "device_prefix_ms_median": med("device_ms"),
          "host_head_ms_median": med("host_ms"),
          "device_prefix_ms": [p["device_ms"] for p in parts],
          "vector_width": int(cpu_vec[0].shape[1]),
          "launches": launches, "h2d_copies_per_batch": copies / n_batches,
          "onehot_slots": onehot_slots,
          "bucketize_slots": bucket_slots,
          "records_equal_cpu": True, "prefix_bitwise_cpu": True})

    # 4b. the scoring server: records one request each
    server = phase_serving_server(torch, KE, model, batches, cpu_plan)

    # 5. tree kernels
    tree_err = phase_tree_parity(torch, dev)
    tree_t = phase_tree_timing(torch, dev)

    # 6. training parity against the JAX package's fixture (also the warm-up)
    phase_training_parity(torch, dev)

    # 7. training at full width
    train = phase_training(torch, KE, dev)

    # 8. the linear families against the JAX package's record (the warm-up
    # of phase 9)
    phase_linear_parity(torch, dev)

    # 9. bench.py's 4-family sweep at full width, then save, load and evaluate
    tdef = phase_training_default(torch, KE, dev)

    # 10. the wide pipeline trained from raw columns
    raw = phase_training_raw(torch, KE, dev)

    # 11. regression and multiclass selection against the JAX package's record
    phase_selection_parity(torch, KE, dev)

    # 12. K1 and K2 at 100 classes; forest regression's float K1
    wide = phase_wide_label_kernels(torch, dev)

    # 13-14. the default regression and multiclass selectors at full width
    treg = phase_training_regression(torch, KE, dev)
    tmc = phase_training_multiclass(torch, KE, dev)

    # 15. the text, date, list, multi-pick and geolocation families
    fam = phase_families(torch, KE, dev)

    # 16. summary
    kernels = []
    tree_src = "transmogrifai_tpu_torch/perf/kernels/csrc/trees.cu"
    for kname, replaces in (("hist_level", "transmogrifai_tpu/perf/kernels/histogram.py:80"),
                            ("split_scan", "transmogrifai_tpu/perf/kernels/splitscan.py:116"),
                            ("row_select_lanes",
                             "transmogrifai_tpu/perf/kernels/routing.py:86")):
        entry = {"name": kname, "route": "cuda", "source": tree_src,
                 "replaces": replaces, "launches": train["launches"][kname],
                 "launches_training_default": tdef["launches"][kname],
                 "launches_training_regression": treg["launches"][kname],
                 "launches_training_multiclass": tmc["launches"][kname],
                 "launches_training_multiclass_100": tmc["wide"]["launches"][kname],
                 "max_abs_err": tree_err[kname]["max_abs_err"], "parity": "bitwise",
                 **tree_t[kname]}
        if kname == "hist_level":
            h = tree_err[kname]
            entry["parity"] = "int8 path bitwise"
            f_levels = [e for e in entry["levels"] if e["path"] == "float32"]
            entry["f32"] = {**entry["f32"],
                            "max_abs_err": max([h["f32_max_abs_err"]]
                                               + [e["max_abs_err"] for e in f_levels]),
                            "max_err_over_tol": max([h["f32_max_err_over_tol"]]
                                                    + [e["max_err_over_tol"]
                                                       for e in f_levels]),
                            "parity": "within 1e-5 x |gh| histogram + 1e-6 of "
                                      "the plain version; bitwise run to run"}
            entry["channel_tiled"] = {"int8_200": wide["int8"], "f32_200": wide["f32"],
                                      "launches_training_multiclass_100":
                                      tmc["wide"]["launches"]["hist_level.chan_tiled"]}
            entry["forest_regression_f32"] = wide["forest_regression_f32"]
        if kname == "split_scan":
            entry["parity"] = "bitwise on integer histograms"
            entry["f32"] = {k: tree_err[kname][f"f32_{k}"] for k in
                            ("cases", "index_mismatches", "max_abs_err",
                             "max_err_over_tol")}
            entry["f32"]["parity"] = ("float histograms of a GBT level: gain within "
                                      "1e-4 x (parent score + |gain|) + 1e-6 of the "
                                      "plain version; bitwise run to run")
            entry["unstaged_k100"] = {
                **wide["split_scan_k100"],
                "launches_training_multiclass_100":
                tmc["wide"]["launches"]["split_scan.unstaged"]}
        if kname == "row_select_lanes":
            entry["launches_by_path"] = {k: train["launches"][f"row_select_lanes.{k}"]
                                         for k in ("tile", "direct")}
        kernels.append(entry)
    for kname, replaces in (("onehot_codes", "transmogrifai_tpu/perf/kernels/encode.py:76"),
                            ("bucketize_right_encode",
                             "transmogrifai_tpu/perf/kernels/encode.py:105")):
        t = timings[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "transmogrifai_tpu_torch/perf/kernels/csrc/encode.cu",
            "replaces": replaces, "launches": launches["encode_slots"],
            "slots_per_launch": onehot_slots if kname == "onehot_codes" else bucket_slots,
            "max_abs_err": max(t["max_abs_err"], fused["max_abs_err"]),
            "parity": "bitwise",
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "library": t["library"],
            "shape": t["shape"],
            "timing": "ms/device_ms/plain_ms/bound_ms/library_ms: one slot "
                      "(one-slot table) at the serving shape; fused_*: the "
                      "serving batch's whole table in one launch",
            **({"splits5000": t["splits5000"]} if "splits5000" in t else {}),
            "launches_serving_server": server["pipelined"]["launches"],
            "launches_serving_server_lockstep": server["lockstep"]["launches"],
            "launches_training_raw": raw["launches"]["encode_slots"],
            "training_raw": raw["encode_at_rows"],
            **({"launches_training_families": fam["launches"]["encode_slots"],
                "launches_serving_families": fam["serving"]["launches"]["encode_slots"],
                "launches_serving_server_families": fam["server"]["launches"],
                "training_families": fam["encode_at_rows"]}
               if kname == "onehot_codes" else {}),
            **{f"fused_{k}": fused[k] for k in ("ms", "device_ms", "plain_ms",
                                                 "bound_ms", "slots", "columns")}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
