#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase deploy     # phase 25 alone, its line only
    python3 chip_smoke.py --phase registry   # phase 27 alone, its lines only
    python3 chip_smoke.py --phase static     # phase 28 alone, its lines only
    python3 chip_smoke.py --phase mesh       # phase 29 alone, its lines only

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
               (c) Workflow.train at FAMILY_ROWS (131 072) with the counters
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
16. examples — the reference's example apps through the port's entry points
               on the card (tests/torch_examples_data.py: their data as
               numpy records, read through CustomReader; no pandas), held to
               the JAX package's record (fixtures/examples,
               tools/make_torch_examples_fixture.py): Titanic
               (Workflow.set_reader -> train -> summary_pretty -> evaluate),
               Iris and Boston (App().main train with a --model-location
               under build/examples, then score and evaluate runs through
               WorkflowRunner) and the dataprep readers (aggregate,
               conditional, custom).  Each winner and grid equal to the
               record's (or tying it within 1e-4 in both: Boston's ridge and
               gaussian GLM at reg 0.01 are one model), the linear and tree
               rows within their tolerance
               (torch_examples_data.EXAMPLE_TOL; the forests' printed beside
               the record), Titanic's metrics within 1e-4 and its cv_auPR in
               0.67-0.90, the apps' scores beside the record's (Iris's
               classes equal wherever the record's top two probabilities are
               0.1 apart and its probabilities within the spread of the
               multinomial refit over every first Adam step a summation
               order can give, torch_examples_data.refit_spread; Boston's
               predictions within 1e-3 of their value),
               and K1-K3 (and K4 for Titanic) launched during each train,
               the counters zeroed just before.  Whether the card's Python imports pandas is
               printed.
17. dsl      — phase 10's table at DSL_ROWS (262 144) plus the DSL's
               features (tests/torch_wide_data.py::dsl_pipeline: 8
               NumericBucketizers, 8 arithmetic features, to_occur and
               exists on 4 pick lists, a PercentileCalibrator, an alias and a
               map_to) through transmogrify -> sanity_check -> the LR
               selector -> Workflow.train on the card, the counters zeroed
               just before: one flush encodes all 48 slots (8 left-closed)
               in one launch, bitwise and timed beside its bound; then the
               serving plan over 16 batches of 1024 records, one launch of 48
               slots a batch, records equal to the CPU plan's.  Train
               seconds, records/s and the encode ms are printed beside phase
               10's.
18. maps     — typed maps and the raw feature filter
               (tests/torch_maps_data.py: a CRM object's custom fields as a
               RealMap, CurrencyMap, IntegralMap, BinaryMap, PickListMap,
               MultiPickListMap, TextMap, TextAreaMap, DateMap and
               GeolocationMap, two PickLists, an auto-bucketized Real and
               reals; a scoring table with a shifted key, an emptied map, a
               key whose nulls track the label and a protected shifted Real)
               through Workflow().with_raw_feature_filter(...) -> transmogrify
               -> SanityChecker -> a 3-fold LR selector on the card.  (a) At
               the record's 4096 rows (scoring 1024): the filter's
               distributions, metrics and blacklist, the fitted states and
               the training vector's sha256 equal to the JAX package's record
               (fixtures/training_maps, tools/make_torch_maps_fixture.py), LR
               CV within 1e-4 and the coefficients within rtol 1e-4 / atol
               1e-5, the filter's two histogram passes on the card and the
               flush's 3 slots in one encode launch.  (b) Workflow.train at
               MAPS_ROWS (scoring a quarter), the counters zeroed just before:
               seconds by part (the filter, its histograms by CUDA events
               beside their bound, the map stages' fits and host transforms,
               the flush and its encode launch, bitwise and timed, the
               SanityChecker, the selector).  (c) save -> load ->
               serving_plan() over 16 batches of 1024 records (maps missing,
               empty, or short of keys): one encode launch of 3 slots a batch,
               records equal to the CPU plan's, records/s.  (d) The JAX
               package's saved model (the record's) serves the record's
               requests on the card equal to the CPU plan's and within 1e-12
               of the JAX plan's.
19. text     — the text stack (fixtures/text_stack, the JAX package's record,
               tools/make_torch_text_fixture.py): examples/text_reviews.py
               with the import swapped, on the card (fitted states and the
               training vector's sha256 equal, LR CV and the metrics within
               1e-4, the side workflow's language and NER maps equal for
               every row, the category slot in the encode kernel); the
               tokenizer, stop-word, bigram, HashingTF and CountVectorizer
               blocks' sha256 at 2000 rows with no Python hashing path; NER
               over the reference's real-prose sentences (en, es, nl);
               Word2Vec and LDA fitted on the card with the record's draws
               fed to their seams (vectors within 1e-5, topic-word matrix
               and the E-step's gamma within 1e-4 relative of the record;
               within 1e-6 / 1e-4 of the same fits on the CPU; Word2Vec
               bitwise run to run); the JAX-saved text model scoring on the
               card (within 1e-5 of the CPU plan and of the record).  Then
               the text pipeline (tests/torch_text_data.py) at its default
               widths at TEXT_ROWS: Workflow.train on the card by part
               (tokenizer, host stages, Word2Vec's pairs and its step loop
               with steps/s, a step's time and kernels, LDA's count matrix
               and EM, flushes, checker, selector), LDA's E-step ms an
               iteration against its bound, peak device memory, save ->
               load -> 16 served batches of 1024 (one encode launch a batch,
               LDAModel's E-step on the card a batch), and NER alone on
               TEXT_NER_ROWS documents.
20. workflow_cv — the wide pipeline (phase 10's table, 3 folds; LR over 2
               grids and an MLP with 10 tanh units) through
               Workflow().with_workflow_cv().train() on the card: the
               bucketizers and the checker re-fitted per fold, every fold's
               8 bucketize slots transformed in ONE encode launch.  (a) At
               the record's 8192 rows (fixtures/workflow_cv, the JAX
               package's, the MLP's draws fed from it): every fold's splits,
               kept indices and vector sha256 equal, LR CV within 1e-4, MLP
               CV within WCV_MLP_TOL, the winner, the refit within rtol 1e-4
               / atol 1e-5; the fold transform one launch of 3 x 8 slots,
               bitwise against encode_slots_torch on the card, and every
               fold's vector bitwise the CPU plan's; model_insights() of the
               JAX-saved model equal to the record (1e-6 relative), the
               card-trained one's within WCV_TRAINED_INSIGHTS_TOL and its
               MLP CV entries within WCV_MLP_TOL; the MLP swept again with TF32 on (a control of
               lower precision, its deviation printed); LOCO of the
               JAX-saved model over 256 rows on the card within 1e-9 of the
               record.  (b) At WCV_ROWS, the counters zeroed just before:
               seconds by part (the before fit, each fold's bucketizer and
               checker fits and flushes, the fold transform and its launch
               by CUDA events beside its bound, its plain version and the
               library composite, each fold's sweep by family, the MLP's
               Adam steps/s, the refit), the same train without workflow CV
               beside it, peak device memory.  (c) LOCO over WCV_LOCO_ROWS
               served records of that model on the card: the active pairs
               re-scored, the device and host milliseconds, records/s, and
               model_insights()'s seconds.
21. streaming — Spark-free scoring, streaming, durable training and the
               continual loop on the card.  (a) Parity: STREAM_PARITY_RECORDS
               of the serving fixture's records as JSON lines through
               MicroBatchStreamingReader and WorkflowRunner's STREAMING_SCORE
               in micro-batches of 1024: one encode launch of 40 slots a
               batch, each batch's scores bitwise the CPU's, the committed
               offset the file's length and a restarted reader replaying
               nothing; score_function(model) on the card equal to
               model.score; serving_wide's export refused as the JAX package
               refuses it (its decision-tree bucketizers), so the bundle is
               exported from fixtures/training_families and scored in a
               process that cannot import torch or jax, within 1e-6 of
               LocalScorer on the card.  (b) STREAM_RECORDS streamed, timed by
               part (JSONL read and parse, extract, host encode, device prefix
               and its launch by CUDA events, head, write, commit), one encode
               launch a batch; LocalScorer's p50/p99 of one record and its
               records/s at 1024; the bundle's records/s at 1024.  (c) Phase
               10's raw table at CONT_TRAIN_ROWS through transmogrify, the
               checker and a 3-fold selector over LR and GBT (the example's
               grids) on the card; CONT_STREAM_RECORDS labelled records
               behind ScoringServer through ContinualTrainer (the second half
               shifted by CONT_SHIFT on a quarter of the Reals) while a side
               client keeps requesting: drift fires, the warm refit on a
               65 536-record window with the prefix frozen builds and loads
               no kernel, reuses the prefix and launches K1-K3 (the GBT), the
               candidate shadows and is promoted sharing the prefix, and a
               FaultHarness breaker trip inside probation rolls back (TM808).
               (d) bench.py's 4-family sweep at RESUME_ROWS with resume=dir,
               killed at the third family's device sync (the first two
               families' blocks committed); the resumed run has 2 journal
               hits, launches only the other two families (K1-K3 only the
               GBT's levels and the refit's) and ends bitwise equal to an
               uninterrupted run; an injected "CUDA out of memory" at the
               GBT's launch degrades it to the next row bucket (TM822) and
               commits nothing under its full-fidelity key.
22. fleet    — FleetServer(max_batch=1024, max_wait_ms=2) on the card
               (serve/registry.py).  (a) Each fingerprint alone: the plan's
               static estimate (checkers/plancheck.py) must lie between 1x
               and 4x the rise of max_memory_allocated over warm() and one
               1024-record batch; the wide model's bf16 and int8 plans
               at full width give prefix vectors bitwise (int8) and within
               one bf16 ulp of their CPU plans'.  (b) Tenants: wide_f32 and
               wide_f32_twin (the fixture loaded twice: the twin allocates
               no device byte and builds no staging), families at f32, bf16
               and int8 (the TM511 gate passes them on 1024 of their
               records); wide_bf16 and wide_int8 are refused with TM511 on
               1024 of the phase's records in both packages (a value within
               a bf16/int8 step of a tree bucketizer's split flips its
               bucket), leaving nothing behind.  (c) 8 client threads, 128
               requests outstanding each, mix the tenants' requests: one
               encode launch per tenant sub-batch with the counters zeroed
               just before, no staging or landing allocation after warm(),
               every record equal to its tenant's CPU plan's for the
               sub-batch it was served in, the reduced tenants' prefix
               vectors as in (a) and their scores within TM511_BOUNDS of the
               f32 tenant's; records/s and each tenant's p50/p99 printed.
               (d) A FaultHarness route fault on families fails only its
               records.  (e) Admission: with a budget that fits one more
               tenant only without the least recently scored one, the
               workflow-CV fixture's model evicts families_int8 and
               memory_allocated falls by the bytes its plan released (within
               the allocator's 512-byte rounding); a candidate over an empty
               registry's budget is refused with TM509, nothing changed.
23. obs      — the telemetry layer (obs/, perf/timers.py, utils/listener.py)
               on the card's paths, sizes cut to keep it near 25 s.  (a)
               ScoringServer(max_batch=1024, max_wait_ms=2) over 4 096
               serving_wide requests from 8 clients: telemetry off, at the
               batch detail, at the requests detail, off again; every record
               equal to the CPU plan's for its batch, 0 compile events after
               warm(), statusz's device_seconds / padding_rows = the plan's
               sums; at the requests detail every request's begin/end pair
               links to a flushed batch_seq and the slowest request's chain
               has encode, device and host; flushed on size, the records
               with telemetry on == off.  (b) serving_wide + training_families
               behind one FleetServer: per-tenant device seconds sum to the
               batch total, statusz shows the plans' own.  (c) TMOG_PROFILE
               around one served batch in a fresh process: the capture
               names encode_slots_kernel, records equal an unprofiled
               batch's; in the script's process the records must equal too
               and the kernels its capture holds are reported.  (d)
               phase 10's table at 65 536 rows under a 2-fold LR + GBT
               selector, untraced and with Workflow.train(telemetry=dir):
               K1-K3 and the encode kernel launch; trace.json's train.* spans
               of the reference's names nest; metrics.jsonl one compile line
               with 0 nvcc builds; the trained model's plan warming records
               its bucket allocations; a warm refit records 0 events and no
               TM901; a cold bucket in a warm context raises TM901.  (e)
               WorkflowRunner TRAIN with collect_stage_metrics at 8 192 rows:
               a fit record per estimator and a transform record per stage;
               the card's memory fields from torch.cuda.
24. ooc      — out-of-core training and scoring (data/chunked.py,
               readers/prefetch.py, workflow/ooc.py): phase 10's wide
               pipeline with an LR (2 grids) + GBT selector at OOC_ROWS
               (65 536 rows = 8 chunks of 8192).  (a) Trained in memory, then
               on ChunkedDataset.from_dataset of the same table with
               train(host_budget=B), B the largest fit set (the checker's
               label and 866-wide vector): fitted states equal, the winner,
               every CV metric and the winner's arrays bitwise equal, the
               encode kernel launched once per chunk of the one epoch with
               slots (counters zeroed just before), one tile allocation per
               epoch with a device prefix, K1-K3 as in memory; seconds by
               part (the table's spill, the epochs: host encode, copies,
               device, the outputs' spill; prefetch wait and overlap; each
               fit), bytes spilled, the prefetcher's stalls.  (d) The
               flush's analyze_transform_plan estimate within 1x-4x of the
               rise of max_memory_allocated over that flush; train(
               hbm_budget=) under it and a chunk tile under its own refused
               with TM601 before any encode launch.  (c) At OOC_RESUME_ROWS
               (4 chunks) under train(resume=dir), a non-retryable fault at
               ingest_chunk chunk 2; the re-run records chunk_resume with 2
               skipped and ends bitwise an uninterrupted chunked train.  (b)
               score_dataset over that chunked table (a plan of 8192-record
               buckets): records equal to in-memory scoring of the same rows
               in the same batches, one encode launch per chunk; records/s
               beside the in-memory plan's.  (e) The chunk tile's launch (40
               slots over 8192 x 728) bitwise its plain version, timed beside
               its bound, plain version and library composite.
25. deploy   — the deploy artifact store (deploy/, perf/programs.py): the
               serving_wide model packed on the card (buckets 8..1024, the
               encode library; bytes by object kind), then booted from the
               artifact in a fresh process (this script with --deploy-child)
               whose kernel build directory is empty and which has no CUDA
               toolkit (CUDA_HOME an empty dir, no nvcc on PATH): a
               FleetServer of two tenants (artifact=root and
               artifact=ArtifactStore(root)) serves DEPLOY_RECORDS records,
               flushed on size into sub-batches of 128 per tenant.  Gates: no
               nvcc_build, one library_load (a cache hit), no compile event
               after register, one artifact_hydrated event with no live
               bucket, encode launches (zeroed after register) == sub-batches,
               records == this process's live plan's on the same sub-batches
               (through JSON).  Beside it, in a process of its own, a cold
               boot without the artifact (nvcc present, an empty build dir):
               its nvcc seconds.  Both boots' seconds from spawn to the first
               scored record, the hydrate's seconds by part.  A truncated bucket object and a truncated
               library object each refused (TM510, one artifact_refused),
               the live build then bitwise; the hydrated plan's prefix
               output bitwise its plain version and the eager plan's.
26. cli      — the operator CLI and the kernel autotuner (cli/, perf/
               autotune.py).  (a) `cli tune run --format json` of every
               family into a temporary store, then sweeps at the main path's
               shapes (CLI_SWEEPS), every candidate held to its kernel's
               plain version on the card.  (b) A child `cli tune show` reads
               that store with 0 sweeps and the same tune= token.  (c) Phase
               10's table at CLI_TRAIN_ROWS under LR + RF + GBT, untuned,
               recording the shape class of every K1-K3 and encode launch;
               each class is swept, and the train runs again with each
               class's fastest verified non-default plan adopted: every
               family's launches take it, RF and LR CV bitwise the untuned
               train's, GBT within 1e-3, the winner equal, a plan's
               fingerprint moving with the tune= token.  (d) In child
               processes: `cli train --resume` SIGKILLed after its first
               journal commit and resumed (bitwise an uninterrupted run's),
               `cli serve --model` (rows == the CPU plan's), `serve --models`
               of two tenants then `top --once`, `serve --follow --refit`
               (0 kernel builds in the refit), `cli gen` whose generated test
               passes.  At most 60 s.
27. registry — every case of the registry sweep (tests/torch_registry_cases.py,
               the reference's tests/test_stage_registry_specs.py table) with
               a device half: fitted where it is an estimator and transformed
               through one fused plan, on the card and on the CPU in this
               process (the random draws made on the CPU for both, TF32
               off).  The card's output equals the CPU's, bitwise or to
               REGISTRY_TOL (the float fits' family rules); an encode slot
               launched the encode kernel, a tree fit K1-K3, every other
               device half allocated on the card, with the counters zeroed
               before each case.  One line per case (its half, seconds on the
               card, launches, max |diff|), then the phase's totals.  At
               most 30 s.
28. static   — static analysis (checkers/, cli/lint.py) on the card.  (a)
               With the launch counters zeroed, measure_compiles open and the
               peak memory statistics reset: Workflow.validate(cost=True,
               host_budget=, rows=) over the unfitted wide pipeline,
               WorkflowModel.validate(serving=True, cost=True, hbm_budget=
               the card's memory) over serving_wide and irsnap.build_corpus():
               0 launches, 0 compile events, max_memory_allocated unchanged.
               (b) At each bucket of serving_wide's ladder (a fresh plan, one
               batch) and at the training flush of phase 26's table at
               CLI_TRAIN_ROWS: the static bytes, FLOPs and bound time
               (bytes / 3.35 TB/s or FLOPs / 67 TFLOP/s, the larger) beside
               the measured device ms (CUDA events) and their ratio, and the
               static peak estimate beside the measured peak rise, which it
               must not undercut.  (c) train(strict=True) and
               train(strict=False) of that table under LR + RF + GBT, one
               seed: CV metrics and the winner bitwise equal (GBT within
               1e-3), K1-K3 and encode launches equal and above 0; a planted
               label leak raises TM401 with 0 launches and no allocation.
               (d) Child processes: `cli lint` over the port's code (every
               function, TM306, TM31x) exits 0; `cli lint --model
               serving_wide --serving --cost --hbm-budget` exits 0 at the
               card's memory and 1 with TM601 at half the static estimate;
               the op-graph corpus captured with CUDA operands against the
               committed tests/goldens/torch_ir: 0 TM700, 0 TM704, the
               TM701/TM702 counts and the ops that drift.  At most 30 s.
29. mesh     — data-parallel training over torch.distributed (parallel/).
               Child processes of this script (`--mesh-child`), each with
               a group timeout, run distributed.initialize -> global_mesh ->
               use_mesh -> Workflow.train on phase 26's table (LR + RF + GBT)
               while this process trains it without a mesh: (a) one rank on
               NCCL, (b) two ranks sharing the card over gloo (NCCL refuses
               two ranks on one device).  Gates: RF CV bitwise, GBT within
               1e-3, LR within 1e-4 and the unmeshed winner in both; (a)
               counts NCCL collectives and no other backend; in (b) every
               rank launches K1, K2, K3 and the encode kernel, the ranks'
               models are bitwise equal, and the checker's ring correlation
               (past 512 columns) is within 1e-5 of the one-card product.
               (c) Ungated: the deepest RF level's histogram bytes, its
               all-reduce time and its K1 time per rank.  A rank that fails
               or runs past MESH_WALL_S fails the phase.  At most 45 s.
30. summary  — nvidia-smi's line, then one {"kernels": [...]} line (each
               entry with launches_static, the strict train's, and
               launches_mesh, each mesh rank's), then the last line
               {"ok": true, "device": {...}}.

Phase 3 also holds K5 past shared memory (a 5000-split slot, its own launch
reading the splits from global memory) bitwise against its plain version
and times it, and the left-closed slot (NumericBucketizer's) bitwise at
1024 rows x 1 slot in every flag setting, at DSL_ROWS x 8 slots and past
4096 splits, timed beside its bound, plain version and library composite; phase 5 holds K1's int8 path just above 2**31 // 127 rows
(0/1 weights) bitwise against its plain version and times it, and times
K1's library call at the float level's own 1 048 576 rows.

Any failure raises: the script exits non-zero and prints no last line.
It imports torch and the port only, never JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

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
#: the families record (tools/make_torch_families_fixture.py; phase 21
#: exports its model's bundle) and the rows of the families train timed by
#: phase 15 (262 144 until phase 21 took its share of the script's time)
FAMILIES_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures",
                                "training_families")
FAMILY_ROWS = 1 << 17
#: the JAX package's record of the reference's example apps
#: (tools/make_torch_examples_fixture.py) and where the apps save their models
EXAMPLES_RECORD = os.path.join("transmogrifai_tpu_torch", "fixtures", "examples",
                               "record.json")
EXAMPLES_DIR = os.path.join("build", "examples")
#: rows of the dsl phase (phase 10's table plus the DSL's features) and the
#: slots its flush and each served batch encode: 32 one-hot + 8 tree
#: bucketize (right-closed) + 8 NumericBucketizer (left-closed)
DSL_ROWS = 1 << 18
DSL_SLOTS = 48
DSL_LEFT_SLOTS = 8
#: the maps record (tools/make_torch_maps_fixture.py) and the rows of the maps
#: train timed by phase 18 (its scoring table a quarter of them); the slots
#: of its flush and of each served batch: the two pick lists' one-hot and the
#: auto-bucketized Real (262 144 rows until phase 21 took its share)
MAPS_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "training_maps")
MAPS_ROWS = 1 << 17
MAPS_SLOTS = 3
#: the JAX package's record of the text stack (tools/make_torch_text_fixture.py),
#: the rows of the text pipeline timed by phase 19 and of its NER timing: at
#: 65 536 rows the phase took 289 s, past its ~120 s share of the script
#: (the host's tokenizer and language detector ~1 ms a row each), so it ran
#: half of them, and a quarter since phase 21 took its share of the script
TEXT_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "text_stack")
TEXT_ROWS = 1 << 14
TEXT_NER_ROWS = 4096
#: the JAX package's record of the wide pipeline trained with workflow-level
#: CV (tools/make_torch_workflow_cv_fixture.py), the rows of phase 20's
#: timed train and its served LOCO records; the MLP's CV metrics are held
#: to WCV_MLP_TOL of the record, as LR's are
WCV_FIXTURE = os.path.join("transmogrifai_tpu_torch", "fixtures", "workflow_cv")
WCV_ROWS = 1 << 18
WCV_LOCO_ROWS = 1024
WCV_MLP_TOL = 1e-4
#: the card-trained model's insights against the record, the MLP's CV
#: entries aside: they carry the refit's float32 work (its coefficients,
#: the checker's statistics), as the coefficients' own rule does
WCV_TRAINED_INSIGHTS_TOL = 1e-5
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


#: the script's start on the host clock: each phase line carries its
#: seconds since (``elapsed_s``)
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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
    t["bucketize_left_encode"] = k_left_closed(torch, KE, dev)
    emit({"phase": "kernels", **{k: v for k, v in t.items()}})
    return t


def _left_library(torch, ins, table):
    """One torch.bucketize + one_hot composite per left-closed slot (buckets
    only, no invalid/null columns): the library yardstick."""
    F = torch.nn.functional
    outs = []
    for k, x in enumerate(ins):
        s = table.splits_on(x.device)[table.split_off[k]:table.split_off[k]
                                      + len(table.specs[k].splits)]
        nb = int(s.shape[0]) - 1
        outs.append(F.one_hot((torch.bucketize(torch.nan_to_num(x), s, right=True) - 1)
                              .clamp(0, nb - 1), nb).float())
    return outs


def _table_library(torch, ins, table):
    """One library call a slot, concatenated: one_hot of the codes (clamped
    into range) for a one-hot slot, torch.bucketize + one_hot (buckets only)
    for a bucketize slot; the yardstick of a whole-table encode launch."""
    F = torch.nn.functional
    outs = []
    for k, (x, spec) in enumerate(zip(ins, table.specs)):
        if not spec.splits:
            outs.append(F.one_hot(x.long().clamp(0, spec.width - 1), spec.width).float())
            continue
        s = table.splits_on(x.device)[table.split_off[k]:table.split_off[k]
                                      + len(spec.splits)]
        nb = int(s.shape[0]) - 1
        outs.append(F.one_hot((torch.bucketize(torch.nan_to_num(x), s) - 1)
                              .clamp(0, nb - 1), nb).float())
    return torch.cat(outs, 1)


def k_left_closed(torch, KE, dev) -> dict:
    """The left-closed bucketize slot (NumericBucketizer's) against its plain
    version, bitwise: one slot at the serving batch over every flag setting
    and split shape, 8 slots at DSL_ROWS rows, and past 4096 splits (its own
    launch, splits in global memory); then timed at 1 x 1024 and 8 x
    DSL_ROWS beside its bound, its plain version and the library
    composite."""
    from torch_encode_cases import left_slot_case

    cases = 0
    for seed in range(12):                   # 12 one-slot tables: 3 split shapes x 4 flags
        specs, ins = left_slot_case(BATCH, seed, dev, 1)
        specs = [specs[0]._replace(track_nulls=bool(seed & 1),
                                   track_invalid=bool(seed & 2),
                                   width=KE.bucket_width(len(specs[0].splits),
                                                         bool(seed & 1), bool(seed & 2)))]
        tab = KE.plan_slots(specs)
        before = KE.left_closed_launches
        got = KE.encode_slots(ins, tab)
        torch.cuda.synchronize()
        check(KE.left_closed_launches == before + 1
              and torch.equal(got, KE.encode_slots_torch(ins, tab)),
              f"left-closed slot bitwise at {BATCH} rows, case {seed}")
        cases += 1
    specs8, ins8 = left_slot_case(DSL_ROWS, 99, dev, DSL_LEFT_SLOTS)
    tab8 = KE.plan_slots(specs8)
    w8 = tab8.width
    buf8 = torch.empty((DSL_ROWS, -(-w8 // 4) * 4), device=dev)[:, :w8]
    KE.encode_slots(ins8, tab8, buf8)
    torch.cuda.synchronize()
    check(torch.equal(buf8, KE.encode_slots_torch(ins8, tab8)),
          f"{DSL_LEFT_SLOTS} left-closed slots bitwise at {DSL_ROWS} rows")
    cases += 1
    for n in (BATCH, RAGGED, 3001):
        for tn, ti in ((True, True), (False, False), (True, False), (False, True)):
            specs, ins = left_slot_case(n, n, dev, 1, n_splits=BIG_SPLITS)
            specs = [specs[0]._replace(track_nulls=tn, track_invalid=ti,
                                       width=KE.bucket_width(BIG_SPLITS, tn, ti))]
            tab = KE.plan_slots(specs)
            got = KE.encode_slots(ins, tab)
            torch.cuda.synchronize()
            check(torch.equal(got, KE.encode_slots_torch(ins, tab)),
                  f"left-closed slot past shared memory bitwise, n={n} tn={tn} ti={ti}")
            cases += 1
    specs1, ins1 = left_slot_case(BATCH, 3, dev, 1)
    tab1 = KE.plan_slots(specs1)
    w1 = tab1.width
    buf1 = torch.empty((BATCH, -(-w1 // 4) * 4), device=dev)[:, :w1]

    one = lambda: KE.encode_slots(ins1, tab1, buf1)  # noqa: E731
    eight = lambda: KE.encode_slots(ins8, tab8, buf8)  # noqa: E731
    big_specs, big_ins = left_slot_case(BATCH, 5, dev, 1, n_splits=BIG_SPLITS)
    big_tab = KE.plan_slots(big_specs)
    big = lambda: KE.encode_slots(big_ins, big_tab)  # noqa: E731
    b1, b8, bb = KE.bound_bytes(BATCH, tab1), KE.bound_bytes(DSL_ROWS, tab8), \
        KE.bound_bytes(BATCH, big_tab)
    return {
        "parity_cases": cases, "max_abs_err": 0.0, "bound_by": "bytes",
        "shape": [BATCH, w1], "ms": time_ms(one), "device_ms": time_device_ms(one),
        "plain_ms": time_ms(lambda: KE.encode_slots_torch(ins1, tab1, buf1)),
        "library_ms": time_ms(lambda: _left_library(torch, ins1, tab1)),
        "library": "composite: torch.bucketize(right=True) + one_hot per slot "
                   "(buckets only, no invalid/null columns)",
        "bytes": b1, "bound_ms": b1 / HBM_BYTES_PER_S * 1e3,
        "slots8": {"rows": DSL_ROWS, "slots": DSL_LEFT_SLOTS, "columns": w8,
                   "ms": time_big_ms(eight, runs=21, warmup=3),
                   "plain_ms": time_big_ms(
                       lambda: KE.encode_slots_torch(ins8, tab8, buf8), runs=5),
                   "library_ms": time_big_ms(lambda: _left_library(torch, ins8, tab8),
                                             runs=5),
                   "bytes": b8, "bound_ms": b8 / HBM_BYTES_PER_S * 1e3},
        "splits5000": {"splits": BIG_SPLITS, "shape": [BATCH, big_tab.width],
                       "ms": time_ms(big), "device_ms": time_device_ms(big),
                       "plain_ms": time_ms(lambda: KE.encode_slots_torch(big_ins, big_tab),
                                           runs=11, per_run=5),
                       "library_ms": time_ms(lambda: _left_library(torch, big_ins,
                                                                   big_tab)),
                       "bytes": bb, "bound_ms": bb / HBM_BYTES_PER_S * 1e3}}


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
    nbytes = KE.bound_bytes(BATCH, table)
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


def _capture_batches(plan, launches: Optional[list] = None) -> list:
    """Record every batch the plan begins (the records, in order): the
    fixture's head is a float64 product whose last bit can depend on a row's
    place in its batch, so a served record is held to the CPU plan's record
    for the same batch.  With ``launches``, each begin's encode launches on
    its thread go there too."""
    from transmogrifai_tpu_torch.perf.kernels import encode as KE

    seen = []
    begin = plan.begin_score

    def recording(records):
        seen.append(list(records))
        n0 = KE.thread_encode_launches()
        fin = begin(records)
        if launches is not None:
            launches.append(KE.thread_encode_launches() - n0)
        return fin
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
    return plan, plan.encode_operands(ds)


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
    nbytes = KE.bound_bytes(RAW_ROWS, table)
    enc = {"rows": RAW_ROWS, "slots": len(table), "columns": width,
           "chunks": len(table.chunks),
           "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
           "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": time_big_ms(lambda: _table_library(torch, ins, table), runs=5),
           "library": "per slot torch.nn.functional.one_hot(codes) or torch.bucketize + "
                      "one_hot (buckets only), then torch.cat",
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
    nbytes = KE.bound_bytes(FAMILY_ROWS, table)
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


# -- the reference's example apps, and the DSL's features at full width ------------

def _example_counts(KE) -> dict:
    c = _all_counts(KE)
    return {k: c[k] for k in ("hist_level", "split_scan", "row_select_lanes",
                              "encode_slots", "encode_slots.slots")}


def _check_example_kernels(name: str, launches: dict, one_hot: bool) -> None:
    need = ["hist_level", "split_scan", "row_select_lanes"] + (["encode_slots"] if one_hot
                                                              else [])
    check(all(launches[k] >= 1 for k in need),
          f"{name} trained through every kernel its selector uses ({need}): {launches}")


def phase_examples(torch, KE, dev) -> dict:
    """The reference's example apps through the port's entry points on the
    card, their data from tests/torch_examples_data.py (numpy only), held to
    the JAX package's record (fixtures/examples): Titanic (Workflow.set_reader
    -> train -> summary_pretty -> evaluate), Iris and Boston (App().main
    train, then score and evaluate runs through WorkflowRunner, the model
    saved under build/examples), and the dataprep readers."""
    import numpy as np

    import torch_examples_data as E
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.perf.kernels.dispatch import resolve_device

    with open(EXAMPLES_RECORD) as fh:
        record = json.load(fh)
    try:
        import pandas
        pandas_info = {"importable": True, "version": pandas.__version__}
    except Exception as e:  # the card's machine may lack it; the phase does not need it
        pandas_info = {"importable": False, "error": repr(e)}
    check(resolve_device(None).type == "cuda", "entry points default to the card")
    out = {"pandas": pandas_info}

    # Titanic
    reader = E.records_reader(E.titanic_records())
    wf, _, _ = E.titanic_workflow(reader)
    _reset_all(KE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = wf.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _example_counts(KE)
    pretty = model.summary_pretty()
    metrics = E.titanic_metrics(model, reader)
    summary, want = model.summary().to_dict(), record["titanic"]
    check(E.winner_or_tie(summary, want["summary"]),
          f"Titanic winner {summary['bestModelName']} {summary['bestGrid']} == the "
          "record's or ties it")
    rows = E.cv_beside_record(summary, want["summary"])
    check(0.67 <= metrics["cv_auPR"] <= 0.90, f"Titanic cv_auPR {metrics['cv_auPR']}")
    dev_metrics = {k: abs(metrics[k] - want["metrics"][k]) for k in ("auPR", "auROC", "cv_auPR")}
    check(max(dev_metrics.values()) <= 1e-4, f"Titanic metrics within 1e-4: {dev_metrics}")
    _check_example_kernels("Titanic", launches, one_hot=True)
    out["titanic"] = {"train_seconds": seconds, "launches": launches,
                      "winner": summary["bestModelName"], "grid": summary["bestGrid"],
                      "metrics": metrics, "record_metrics": want["metrics"],
                      "metric_deviation": dev_metrics, "cv": rows,
                      "summary_pretty_head": pretty.splitlines()[:4]}

    # Iris and Boston: App().main train, score, evaluate
    os.makedirs(EXAMPLES_DIR, exist_ok=True)
    for name, app, ev in (("iris", E.OpIris, T.Evaluators.multi_classification),
                          ("boston", E.OpBoston, T.Evaluators.regression)):
        loc = os.path.join(EXAMPLES_DIR, name)
        want = record[name]
        _reset_all(KE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with E.refit_inputs() as refits:
            train = app().main(["--run-type", "train", "--model-location", loc])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _example_counts(KE)
        got = train.metrics
        check(E.winner_or_tie(got, want["train"]),
              f"{name} winner {got['bestModelName']} {got['bestGrid']} == the record's "
              f"{want['train']['bestModelName']} {want['train']['bestGrid']} or ties it")
        rows = E.cv_beside_record(got, want["train"])
        _check_example_kernels(name, launches, one_hot=False)
        score = app(ev()).main(["--run-type", "score", "--model-location", loc])
        evaluate = app(ev()).main(["--run-type", "evaluate", "--model-location", loc])
        check(score.metrics == evaluate.metrics and score.metrics,
              f"{name}: the score run's metrics equal the evaluate run's")
        pred = next(n for n in score.scores.names if "modelSelector" in n)
        col = score.scores[pred]
        check(np.isfinite(col.data).all(), f"{name} scores finite")
        refit_bound = None
        if col.prob is not None:
            # the winner's refit sums its first intercept gradient, zero in
            # exact arithmetic, in the card's order, and Adam's first step
            # turns that rounding into a move of up to 0.3 per intercept:
            # its probabilities are held to the spread of the refits over
            # every such first step (torch_examples_data.refit_spread, on
            # the CPU from this train's refit inputs), and its classes to
            # the record's wherever the record's top two are 0.1 apart
            wprob = np.asarray(want["scores"]["prob"])
            score_dev = float(np.max(np.abs(col.prob - wprob)))
            check(len(refits) == 1, f"{name}: one multinomial LR refit ({len(refits)})")
            refit_bound = E.iris_refit_bound(T.WorkflowModel.load(loc), refits[0])
            check(score_dev <= refit_bound,
                  f"{name} probabilities within the refit family's spread of the "
                  f"record's ({score_dev} <= {refit_bound})")
            top2 = np.sort(wprob, axis=1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 0.1
            check(np.array_equal(col.pred[clear], np.asarray(want["scores"]["pred"])[clear]),
                  f"{name} classes equal to the record's on {int(clear.sum())} clear rows")
        else:
            w = np.asarray(want["scores"]["pred"])
            score_dev = float(np.max(np.abs(col.pred - w) / np.abs(w)))
            check(score_dev <= 1e-3, f"{name} predictions within 1e-3 of their value "
                                     f"({score_dev})")
        out[name] = {"train_seconds": seconds, "launches": launches,
                     "winner": got["bestModelName"], "grid": got["bestGrid"],
                     "record_winner": want["train"]["bestModelName"],
                     "record_grid": want["train"]["bestGrid"],
                     "train_evaluation": got["trainEvaluation"],
                     "record_train_evaluation": want["train"]["trainEvaluation"],
                     "score_metrics": score.metrics, "score_max_deviation": score_dev,
                     "refit_bound": refit_bound,
                     "cv": rows}

    # dataprep: the aggregate and conditional readers over a custom reader
    got = E.dataprep()
    check(got == record["dataprep"], f"dataprep {got} == the record's {record['dataprep']}")
    out["dataprep"] = got
    emit({"phase": "examples", **out})
    return out


def _dsl_train(torch, n: int, dev):
    """phase 10's table (tests/torch_wide_data.py, seed 0) plus the RealNN
    ``score`` column, through dsl_pipeline on ``dev``.  Returns (model,
    workflow, handles, dataset, columns, data seconds, train seconds)."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import FIXTURE_SHAPE, dsl_pipeline, make_data, score_column
    from transmogrifai_tpu_torch.types import feature_type_by_name

    t0 = time.perf_counter()
    cols, schema = make_data(n, seed=0, **FIXTURE_SHAPE)
    cols["score"] = score_column(n)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ftypes["score"] = T.types.RealNN
    ds = T.Dataset.from_features(cols, ftypes)
    data_s = time.perf_counter() - t0
    label, sel, chk, pred = dsl_pipeline(T, ftypes, schema)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    _sync(torch, dev)
    t0 = time.perf_counter()
    model = wf.train(device=dev)
    _sync(torch, dev)
    handles = {"label": label, "sel": sel, "chk": chk, "pred": pred}
    return model, wf, handles, ds, cols, data_s, time.perf_counter() - t0


def phase_dsl(torch, KE, dev, raw: dict) -> dict:
    """The wide pipeline with the DSL's features at DSL_ROWS through
    Workflow.train on the card (the counters zeroed just before): one flush
    encodes all DSL_SLOTS slots, the 8 left-closed among them, in one
    launch, bitwise its plain version and timed beside its bound; then the
    serving plan over 16 batches of 1024 records, one launch of DSL_SLOTS
    slots a batch, records equal to the CPU plan's."""
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    model, wf, h, ds, cols, data_s, seconds = _dsl_train(torch, DSL_ROWS, dev)
    launches = _all_counts(KE)
    left = (KE.left_closed_launches, KE.left_closed_slots)
    peak = torch.cuda.max_memory_allocated()
    flushes = [r for r in wf.last_train_profile if r["kind"] == "flush"]
    enc = [r for r in flushes if r.get("encode_slots")]
    check(len(enc) == 1 and enc[0]["encode_slots"] == DSL_SLOTS
          and launches["encode_slots"] == 1 and launches["encode_slots.slots"] == DSL_SLOTS
          and left == (1, DSL_LEFT_SLOTS)
          and launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"one flush encodes {DSL_SLOTS} slots ({DSL_LEFT_SLOTS} left-closed) in one "
          f"launch: {launches} left {left} flushes {flushes}")
    summary = model.fitted[h["sel"].uid].summary
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")

    # the flush's encode launch at DSL_ROWS: bitwise, then timed
    plan, ins = _flush_operands(model, h, ds, dev)
    table = plan._encode_table
    width = table.width
    buf = torch.empty((DSL_ROWS, -(-width // 4) * 4), device=dev)[:, :width]
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          f"the dsl flush's encode launch bitwise at {DSL_ROWS} rows")
    nbytes = KE.bound_bytes(DSL_ROWS, table)
    encode = {"rows": DSL_ROWS, "slots": len(table), "left_closed_slots": table.n_left,
              "columns": width,
              "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
              "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
              "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "in_flush_ms": enc[0]["encode_ms"], "max_abs_err": 0.0}
    del plan, ins, buf

    # serving: 16 batches of 1024 records, each one launch of every slot
    names = [k for k in cols if k != "label"]
    batches = [[{k: cols[k][i] for k in names} for i in range(b * BATCH, (b + 1) * BATCH)]
               for b in range(N_BATCHES)]
    splan = model.serving_plan()
    cpu_plan = model.serving_plan(device="cpu")
    check(len(splan._encode_table) == DSL_SLOTS and splan._encode_table.n_left == DSL_LEFT_SLOTS,
          f"the serving plan's table holds {DSL_SLOTS} slots, {DSL_LEFT_SLOTS} left-closed")
    splan.score(batches[0])
    torch.cuda.synchronize()
    _reset_all(KE)
    served, parts = [], []
    t0 = time.perf_counter()
    for b in batches:
        served.append(splan.score(b))
        parts.append(dict(splan.last_timings))
    wall = time.perf_counter() - t0
    slaunches = _all_counts(KE)
    sleft = (KE.left_closed_launches, KE.left_closed_slots)
    check(slaunches["encode_slots"] == N_BATCHES
          and slaunches["encode_slots.slots"] == N_BATCHES * DSL_SLOTS
          and sleft == (N_BATCHES, N_BATCHES * DSL_LEFT_SLOTS),
          f"one encode launch of {DSL_SLOTS} slots per served batch: {slaunches} {sleft}")
    for b, got in zip(batches, served):
        check(got == cpu_plan.score(b), "served dsl records == the CPU plan's")

    def med(key):
        return statistics.median(p[key] for p in parts)

    out = {"rows": DSL_ROWS, "train_seconds": seconds, "data_host_seconds": data_s,
           "phase10_train_seconds": raw["train_seconds"],
           "flushes": [{k: r.get(k) for k in (
               "seconds", "stages", "encode_slots", "host_stages", "host_stage_seconds",
               "host_encode_s", "h2d_s", "device_s", "encode_ms", "d2h_s")}
               for r in flushes],
           "launches": launches, "left_closed": {"launches": left[0], "slots": left[1]},
           "max_memory_allocated_bytes": peak,
           "winner": summary.best_model_name, "winner_grid": summary.best_grid,
           "cv": [{"grid": e.grid, "values": e.metric_values}
                  for e in summary.validation_results],
           "encode_at_rows": encode, "phase10_encode_at_rows": raw["encode_at_rows"],
           "serving": {"batches": N_BATCHES, "batch": BATCH,
                       "records_per_s": N_BATCHES * BATCH / wall,
                       "encode_ms_median": med("encode_ms"),
                       "device_prefix_ms_median": med("device_ms"),
                       "host_head_ms_median": med("host_ms"),
                       "launches": slaunches,
                       "left_closed": {"launches": sleft[0], "slots": sleft[1]},
                       "records_equal_cpu": True}}
    emit({"phase": "dsl", **out})
    return out


def _maps_train(torch, n: int, dev):
    """The maps pipeline (tests/torch_maps_data.py: seed 0, its scoring
    table of n // 4 rows from seed 1) with its raw feature filter, trained
    on ``dev`` through the port's entry points.  Returns (model, workflow,
    handles, dataset, columns, host seconds of the data, train seconds)."""
    import transmogrifai_tpu_torch as T
    from torch_maps_data import make_maps, make_scoring, maps_filter, maps_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name

    t0 = time.perf_counter()
    cols, schema = make_maps(n, seed=0)
    scols, sschema = make_scoring(n // 4, seed=1)
    t1 = time.perf_counter()
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    sds = T.Dataset.from_features(scols, {s["name"]: ftypes[s["name"]] for s in sschema})
    t2 = time.perf_counter()
    label, sel, chk, pred = maps_pipeline(T, ftypes, schema)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .with_raw_feature_filter(maps_filter(T, sds))
    _sync(torch, dev)
    t3 = time.perf_counter()
    model = wf.train(device=dev)
    _sync(torch, dev)
    seconds = time.perf_counter() - t3
    handles = {"label": label, "sel": sel, "chk": chk, "pred": pred}
    return model, wf, handles, ds, cols, {"make_tables_s": t1 - t0,
                                          "from_features_s": t2 - t1}, seconds


def phase_maps(torch, KE, dev) -> dict:
    """Typed maps and the raw feature filter on the card: (a) the 4096-row
    train against the JAX package's record (fixtures/training_maps); (b)
    Workflow.train at MAPS_ROWS by part; (c) save -> load -> serving_plan()
    over 16 batches of 1024 records, equal to the CPU plan's; (d) the JAX
    package's saved model serving the record's requests."""
    import numpy as np

    from torch_maps_data import fitted_states, make_records, vector_digest
    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.filters import distribution as FD
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    # (a) parity at the record's size
    with open(os.path.join(MAPS_FIXTURE, "states.json")) as fh:
        states = json.load(fh)
    with open(os.path.join(MAPS_FIXTURE, "records.json")) as fh:
        recorded = json.load(fh)
    with open(os.path.join(MAPS_FIXTURE, "rff.json")) as fh:
        rff = json.load(fh)
    _reset_all(KE)
    FD.reset_launch_counts()
    model, wf, h, ds, _, _, seconds_a = _maps_train(torch, states["rows"], dev)
    launches_a = _all_counts(KE)
    check(FD.launches == 2, f"the filter's two histogram passes ran ({FD.launches})")
    check(json.loads(json.dumps(model.rff_summary.to_dict())) == rff["results"]
          and model.blacklist == rff["blacklist"],
          "the filter's distributions, metrics and blacklist == the JAX record "
          f"(blacklist {model.blacklist})")
    check(json.loads(json.dumps(fitted_states(model))) == states["fitted"],
          "fitted states (map keys, fills, vocabularies, SmartText plans, date keys, "
          "kept indices) == the JAX record")
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
    check(launches_a["encode_slots"] == 1 and launches_a["encode_slots.slots"] == MAPS_SLOTS,
          f"the flush's {MAPS_SLOTS} slots in one encode launch: {launches_a}")
    # (d) the JAX package's saved model on the card
    fixture = WorkflowModel.load(MAPS_FIXTURE)
    check(fixture.blacklist == rff["blacklist"], "the JAX-saved blacklist loads")
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

    # (b) Workflow.train at MAPS_ROWS by part, the histograms' operands kept
    hist_args = []
    hist = FD.numeric_histograms

    def keep(values, lo, hi, bins):
        hist_args.append((values, lo, hi, bins))
        return hist(values, lo, hi, bins)

    torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    FD.reset_launch_counts()
    FD.numeric_histograms = keep
    try:
        model, wf, h, ds, cols, data_s, seconds = _maps_train(torch, MAPS_ROWS, dev)
    finally:
        FD.numeric_histograms = hist
    launches = _all_counts(KE)
    peak = torch.cuda.max_memory_allocated()
    check(FD.launches == 2 and len(hist_args) == 2
          and all(a[0].device.type == "cuda" for a in hist_args),
          f"the filter's histograms ran on the card, once a pass ({FD.launches})")
    check(launches["encode_slots"] == 1 and launches["encode_slots.slots"] == MAPS_SLOTS
          and launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"the training path launches the encode kernel once with {MAPS_SLOTS} slots: "
          f"{launches}")
    prof = wf.last_train_profile
    fits = [r for r in prof if r["kind"] == "fit"]
    flushes = [r for r in prof if r["kind"] == "flush"]
    [filt] = [r for r in prof if r["kind"] == "filter"]
    by_stage: dict = {}
    for r in fits:
        by_stage[r["stage"]] = by_stage.get(r["stage"], 0.0) + r["seconds"]
    host_by_stage: dict = {}
    for r in flushes:
        for k, v in (r.get("host_stage_seconds") or {}).items():
            host_by_stage[k] = host_by_stage.get(k, 0.0) + v
    summary = model.fitted[h["sel"].uid].summary
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")
    histograms = []
    for values, lo, hi, bins in hist_args:
        n_rows, d = values.shape
        nbytes = values.numel() * 4 + 2 * d * 4 + d * bins * 4
        histograms.append({
            "rows": n_rows, "columns": d, "bins": bins,
            "ms": time_big_ms(lambda: hist(values, lo, hi, bins), runs=21, warmup=3),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"})
    # the flush's encode launch at MAPS_ROWS, bitwise, then timed
    plan, ins = _flush_operands(model, h, ds, dev)
    table = plan._encode_table
    enc_w = table.width
    buf = torch.empty((MAPS_ROWS, -(-enc_w // 4) * 4), device=dev)[:, :enc_w]
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          f"the maps flush's encode launch bitwise at {MAPS_ROWS} rows")
    nbytes = KE.bound_bytes(MAPS_ROWS, table)
    enc = {"rows": MAPS_ROWS, "slots": len(table), "columns": enc_w,
           "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
           "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": time_big_ms(lambda: _table_library(torch, ins, table), runs=5),
           "library": "per slot torch.nn.functional.one_hot(codes) or torch.bucketize + "
                      "one_hot (buckets only), then torch.cat",
           "max_abs_err": 0.0}
    del plan, ins, buf
    vec_width = int(transform_dag(ds.take(np.arange(8)), [h["chk"].inputs[1]], model.fitted,
                                  dev)[h["chk"].inputs[1].name].data.shape[1])

    # (c) save -> load -> the serving plan on the card, 16 batches of 1024
    path = os.path.join("build", "maps_model")
    model.save(path)
    loaded = WorkflowModel.load(path)
    check(loaded.blacklist == model.blacklist, "the blacklist survives save -> load")
    splan, scpu = loaded.serving_plan(), loaded.serving_plan(device="cpu")
    batches = [make_records(cols, range(i * BATCH, (i + 1) * BATCH)) for i in range(N_BATCHES)]
    check(splan.score(batches[0]) == model.serving_plan().score(batches[0]),
          "the loaded model serves the records the trained one does")
    torch.cuda.synchronize()
    _reset_all(KE)
    rows, parts = [], []
    t0 = time.perf_counter()
    for b in batches:
        rows.append(splan.score(b))
        parts.append(dict(splan.last_timings))
    wall = time.perf_counter() - t0
    launches_serving = _all_counts(KE)
    check(launches_serving["encode_slots"] == N_BATCHES
          and launches_serving["encode_slots.slots"] == MAPS_SLOTS * N_BATCHES,
          f"one encode launch of {MAPS_SLOTS} slots per batch: {launches_serving}")
    for b, got in zip(batches, rows):
        check(got == scpu.score(b), "card records == CPU plan records")
    host_classes = sorted({type(r).__name__ for r in splan._remainder})

    def med(key):
        return statistics.median(p[key] for p in parts)

    out = {"rows": MAPS_ROWS, "scoring_rows": MAPS_ROWS // 4, "train_seconds": seconds,
           "data_host_seconds": data_s, "vector_width": vec_width,
           "blacklist": model.blacklist,
           "parts_seconds": {
               "filter": filt["seconds"],
               "filter_histograms_ms": [x["ms"] for x in histograms],
               "map_stage_fits": sum(v for k, v in by_stage.items() if "Map" in k),
               "stage_fits_host": sum(v for k, v in by_stage.items() if k not in (
                   "SanityChecker", "ModelSelector")),
               "map_host_transforms": sum(v for k, v in host_by_stage.items() if "Map" in k),
               "host_transforms_by_class": host_by_stage,
               "flushes": sum(r["seconds"] for r in flushes),
               "flush_parts": [{k: r.get(k) for k in (
                   "seconds", "stages", "encode_slots", "host_encode_s", "h2d_s",
                   "device_s", "encode_ms", "d2h_s", "host_stages_s", "h2d_bytes",
                   "d2h_bytes")} for r in flushes],
               "sanity_checker": by_stage.get("SanityChecker"),
               "selector": by_stage.get("ModelSelector")},
           "fit_seconds_by_stage": by_stage, "histograms": histograms,
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
                       "launches": launches_serving, "host_stages": host_classes,
                       "records_equal_cpu": True},
           "parity_4096": {"train_seconds": seconds_a, "cv_max_abs_dev": cv_dev,
                           "coef_max_abs_dev": coef_dev, "record_max_abs_dev": rec_dev,
                           "launches": launches_a}}
    emit({"phase": "maps", **out})
    return out


def _text_fed(E, arrays: dict, prefix: str):
    """Seams that hand out the record's draws (``<prefix>w2v_w_in0`` ...)
    on whatever device the fit asks; returns the (w2v, lda) pair."""
    import torch

    def w2v(seed, v, dim, device):
        w_in, w_out = arrays[f"{prefix}w2v_w_in0"], arrays[f"{prefix}w2v_w_out0"]
        check(w_in.shape == (v, dim), f"the recorded Word2Vec draws fit ({w_in.shape})")
        return (torch.from_numpy(w_in.copy()).to(device),
                torch.from_numpy(w_out.copy()).to(device))

    def lda(seed, k, v, device):
        lam0 = arrays[f"{prefix}lda_lam0"]
        check(lam0.shape == (k, v), f"the recorded LDA draw fits ({lam0.shape})")
        return torch.from_numpy(lam0.copy()).to(device)

    return w2v, lda


def _text_docs(rows_of: int, rows: int):
    """The cleaned token lists of the first ``rows`` of the text table of
    ``rows_of`` rows (seed 0): tokenizer -> stop words, on the host."""
    from torch_text_data import make_text
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.ops import text
    from transmogrifai_tpu_torch.types import Text

    cols, _ = make_text(rows_of, seed=0)
    toks = text.TextTokenizer().transform_columns(
        [Column.from_values(Text, cols["review"][:rows])], None)
    return text.StopWordsRemover().transform_columns([toks], None)


def _text_namespace():
    import types

    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.ops import embeddings, text

    return types.SimpleNamespace(
        FeatureBuilder=T.FeatureBuilder, transmogrify=T.transmogrify,
        SanityChecker=T.SanityChecker,
        BinaryClassificationModelSelector=T.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, text=text, embeddings=embeddings)


def _records_within(got: list, want: list, pname: str, tol: float) -> float:
    """Largest deviation of the prediction maps' values over max(1, |value|),
    the other fields and the keys equal; fails past ``tol``.  LDA's E-step
    rounds otherwise on the card (its products, torch's digamma), so a text
    model's scores agree to float32's last bits, not bitwise."""
    worst = 0.0
    check(len(got) == len(want), "one output record per request")
    for g, w in zip(got, want):
        check(g.keys() == w.keys() and g[pname].keys() == w[pname].keys()
              and g[pname]["prediction"] == w[pname]["prediction"]
              and {k: v for k, v in g.items() if k != pname}
              == {k: v for k, v in w.items() if k != pname},
              "records equal but for the prediction's floats")
        worst = max([worst] + [abs(g[pname][k] - w[pname][k]) / max(1.0, abs(w[pname][k]))
                               for k in g[pname]])
    check(worst <= tol, f"prediction values within {tol} ({worst})")
    return worst


def phase_text(torch, KE, dev) -> dict:
    """The text stack on the card: (a) parity with the JAX package's record
    (fixtures/text_stack): examples/text_reviews.py with the import swapped,
    the stage blocks, NER over the real-prose sentences, Word2Vec and LDA
    fitted on the card with the record's draws fed to the seams (and the
    same fits on the CPU), and the JAX-saved text model scoring on the card;
    (b) the text pipeline at its default widths at TEXT_ROWS, timed by part,
    then save -> load -> 16 served batches of 1024, and NER alone on
    TEXT_NER_ROWS documents."""
    import numpy as np

    import torch_text_data as TD
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch import native
    from transmogrifai_tpu_torch.models.base import full_f32
    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.ops import text
    from transmogrifai_tpu_torch.ops.ner import NameEntityRecognizer
    from transmogrifai_tpu_torch.perf.kernels.dispatch import resolve_device
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    with open(os.path.join(TEXT_FIXTURE, "record.json")) as fh:
        record = json.load(fh)
    arrays = dict(np.load(os.path.join(TEXT_FIXTURE, "embeddings.npz")))
    check(resolve_device(None).type == "cuda", "entry points default to the card")
    out: dict = {}

    # (a1) examples/text_reviews.py, the import swapped, on the card
    want = record["text_reviews"]
    _reset_all(KE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = TD.run_text_reviews(os.getcwd(), T, transform_dag, dev)
    seconds = time.perf_counter() - t0
    launches = _all_counts(KE)
    check(got["states"] == want["states"], "text_reviews: fitted states == the JAX record")
    check(got["vector"] == want["vector"],
          f"text_reviews: the training vector bitwise the JAX record's {want['vector']}")
    cv_dev = max(abs(a - b) for g, w in zip(got["cv"], want["cv"])
                 for a, b in zip(g["values"], w["values"]))
    check(cv_dev <= 1e-4, f"text_reviews: LR CV within 1e-4 of the JAX record ({cv_dev})")
    met_dev = {k: abs(got["metrics"][k] - v) for k, v in want["metrics"].items()}
    check(max(met_dev.values()) <= 1e-4,
          f"text_reviews: metrics (AuPR {got['metrics']['auPR']}) within 1e-4: {met_dev}")
    check(got["languages"] == want["languages"] and len(got["languages"]) == 2000,
          "text_reviews: the side workflow's language maps == the record's, every row")
    check(got["ner"] == want["ner"], "text_reviews: NER maps == the record's, every row")
    check(launches["encode_slots"] >= 1
          and launches["encode_slots.slots"] == launches["encode_slots"]
          and launches["onehot_codes"] == 0,
          f"text_reviews: the category slot in one encode launch per pass: {launches}")
    out["text_reviews"] = {"seconds": seconds, "launches": launches, "cv_max_abs_dev": cv_dev,
                           "metrics": got["metrics"], "metric_deviation": met_dev,
                           "rows": len(got["languages"])}
    del got

    # (a2) the stage blocks at the record's rows, no Python hashing
    rec = record["blocks"]
    cols, schema = TD.make_text(rec["rows"], seed=0)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    review = T.FeatureBuilder.of("review", ftypes["review"]).extract_field().as_predictor()
    tokens = review.tokenize()
    clean = tokens.transform_with(text.StopWordsRemover())
    bigrams = clean.transform_with(text.NGramTransformer(n=2))
    counts = bigrams.transform_with(text.CountVectorizer(vocab_size=512))
    hashed = clean.transform_with(text.HashingTF(num_features=512))
    feats = [tokens, clean, bigrams, counts, hashed]
    ds = T.Dataset.from_features({"review": cols["review"]}, {"review": ftypes["review"]})
    check(native.warmup(), f"the native hashing library built ({native.BUILD_ERROR})")
    native.reset_path_counts()
    model = T.Workflow().set_input_dataset(ds).set_result_features(*feats).train()
    blocks = transform_dag(ds, feats, model.fitted, dev)
    paths = _no_python_hashing(native, "the stage blocks")
    for k, f in (("tokens", tokens), ("clean", clean), ("bigrams", bigrams)):
        check(TD.token_digest(blocks[f.name].data) == rec[k], f"{k} sha256 == the record's")
    check(TD.block_digest(blocks[counts.name].data) == rec["counts"]
          and model.fitted[counts.origin_stage.uid].vocab == rec["count_vocab"],
          "CountVectorizer's vocabulary and block == the record's")
    check(TD.block_digest(blocks[hashed.name].data) == rec["hashed"],
          "HashingTF's block sha256 == the record's")
    out["blocks"] = {"rows": rec["rows"], "equal": True, "hashing_paths": paths}

    # (a3) NER over the real-prose sentences
    n_sent = 0
    for lang in ("en", "es", "nl"):
        pinned, auto = NameEntityRecognizer(language=lang), NameEntityRecognizer()
        for r in record["ner"][lang]:
            check(pinned.transform_values([r["sentence"]]) == r["pinned"]
                  and auto.transform_values([r["sentence"]]) == r["auto"],
                  f"NER ({lang}) == the record's: {r['sentence'][:40]}")
            n_sent += 1
    out["ner"] = {"sentences": n_sent, "equal": True}

    # (a4) Word2Vec and LDA with the record's draws, on the card and the CPU
    docs = _text_docs(2000, 400)
    w2v_seam, lda_seam = E.draw_word2vec_init, E.draw_lda_init
    E.draw_word2vec_init, E.draw_lda_init = _text_fed(E, arrays, "")
    placed = []
    fit_lda = E.fit_lda
    cpu = torch.device("cpu")
    try:
        wc, wc2, wp = [E.Word2Vec(embedding_dim=16, max_vocab=200, epochs=2, batch_size=256)
                       .fit_columns([docs], None, d) for d in (dev, dev, cpu)]
        E.fit_lda = lambda x, *a: placed.append(a[-1]) or fit_lda(x, *a)
        lc, lp = [E.LDA(k=4, max_vocab=200, max_iter=5, inner_iter=5)
                  .fit_columns([docs], None, d) for d in (dev, cpu)]
    finally:
        E.draw_word2vec_init, E.draw_lda_init, E.fit_lda = w2v_seam, lda_seam, fit_lda
    check([p.type for p in placed] == ["cuda", "cpu"], f"LDA fitted on {placed}")
    check(wc.vocab == list(arrays["w2v_vocab"]), "Word2Vec vocabulary == the record's")
    w2v_dev = float(np.max(np.abs(wc.vectors - arrays["w2v_vectors"])))
    w2v_cpu = float(np.max(np.abs(wc.vectors - wp.vectors)))
    check(w2v_dev <= 1e-5, f"Word2Vec on the card within 1e-5 of the JAX record ({w2v_dev})")
    check(w2v_cpu <= 1e-6, f"Word2Vec on the card within 1e-6 of the CPU's ({w2v_cpu})")
    check(wc.vectors.tobytes() == wc2.vectors.tobytes(),
          "Word2Vec on the card bitwise from one run to the next")
    lda_dev = float(np.max(np.abs(lc.topic_word - arrays["lda_topic_word"])
                           / np.abs(arrays["lda_topic_word"])))
    lda_cpu = float(np.max(np.abs(lc.topic_word - lp.topic_word) / np.abs(lp.topic_word)))
    check(lc.vocab == list(arrays["lda_vocab"]) and lda_dev <= 1e-4,
          f"LDA's topic-word matrix on the card within 1e-4 (relative) of the JAX "
          f"record ({lda_dev})")
    check(lda_cpu <= 1e-4, f"LDA on the card within 1e-4 (relative) of the CPU's ({lda_cpu})")
    x = E._count_matrix(docs.data, {t: j for j, t in enumerate(lc.vocab)})
    lam = torch.from_numpy(arrays["lda_topic_word"])
    g_card = E.e_step(torch.from_numpy(x).to(dev), lam.to(dev), 0.25, 5)[0]
    check(g_card.device.type == "cuda", "the E-step ran on the card")
    g_card = g_card.cpu().numpy()
    g_cpu = E.e_step(torch.from_numpy(x), lam, 0.25, 5)[0].numpy()
    gam_dev = float(np.max(np.abs(g_card - arrays["lda_gamma"]) / np.abs(arrays["lda_gamma"])))
    gam_cpu = float(np.max(np.abs(g_card - g_cpu) / np.abs(g_cpu)))
    check(gam_dev <= 1e-4 and gam_cpu <= 1e-4,
          f"the E-step's gamma on the card within 1e-4 of the JAX record ({gam_dev}) "
          f"and of the CPU's ({gam_cpu}), relative")
    out["embeddings"] = {"w2v_max_abs_dev_record": w2v_dev, "w2v_max_abs_dev_cpu": w2v_cpu,
                         "w2v_card_run_to_run": "bitwise",
                         "lda_max_rel_dev_record": lda_dev, "lda_max_rel_dev_cpu": lda_cpu,
                         "gamma_max_rel_dev_record": gam_dev, "gamma_max_rel_dev_cpu": gam_cpu}

    # (a5) the JAX-saved text model scoring on the card
    rec = record["pipeline"]
    jmodel = T.WorkflowModel.load(os.path.join(TEXT_FIXTURE, "model"))
    jplan, jcpu = jmodel.serving_plan(), jmodel.serving_plan(device="cpu")
    rec_dev = cpu_dev = 0.0
    for b in rec["batches"]:
        got = jplan.score(b["records"])
        cpu_dev = max(cpu_dev, _records_within(got, jcpu.score(b["records"]),
                                               rec["prediction"], 1e-5))
        rec_dev = max(rec_dev, _records_within(got, b["scored"], rec["prediction"], 1e-5))
    out["jax_saved_model"] = {"records": sum(len(b["records"]) for b in rec["batches"]),
                              "max_abs_dev_cpu_plan": cpu_dev, "max_abs_dev_record": rec_dev}
    del jmodel, jplan, jcpu, model, blocks

    # (b) the text pipeline at its default widths, timed by part
    t0 = time.perf_counter()
    cols, schema = TD.make_text(TEXT_ROWS, seed=0)
    t1 = time.perf_counter()
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    t2 = time.perf_counter()
    label, sel, chk, pred, h = TD.text_pipeline(_text_namespace(), ftypes, wide=True)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    timers: dict = {}
    kept: dict = {}

    def timed(name, fn, keep=None):
        def run(*a, **kw):
            s = time.perf_counter()
            r = fn(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            timers[name] = timers.get(name, 0.0) + time.perf_counter() - s
            if keep is not None:
                kept[keep] = a
            return r
        return run

    originals = {k: getattr(E, k) for k in ("skipgram_pairs", "skipgram_epoch",
                                            "train_skipgram", "fit_lda", "_count_matrix")}
    E.skipgram_pairs = timed("w2v_pairs", originals["skipgram_pairs"])
    E.skipgram_epoch = timed("w2v_draws", originals["skipgram_epoch"])
    E.train_skipgram = timed("w2v_card", originals["train_skipgram"], keep="w2v")
    E.fit_lda = timed("lda_em", originals["fit_lda"], keep="lda")
    E._count_matrix = timed("lda_count_matrix", originals["_count_matrix"])
    torch.cuda.reset_peak_memory_stats()
    _reset_all(KE)
    E.reset_launch_counts()
    native.reset_path_counts()
    try:
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        model = wf.train(device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t3
    finally:
        for k, v in originals.items():
            setattr(E, k, v)
    peak = torch.cuda.max_memory_allocated()
    launches = _all_counts(KE)
    emb_counts = E.launch_counts()
    paths = _no_python_hashing(native, "the text pipeline")
    check(launches["encode_slots"] >= 1 and launches["onehot_codes"] == 0,
          f"the text pipeline's pick lists went through the encode kernel: {launches}")
    check(kept["w2v"][-1].type == "cuda" and kept["lda"][-1].type == "cuda",
          "Word2Vec and LDA trained on the card")
    w2v_m = model.fitted[h["w2v"].origin_stage.uid]
    lda_m = model.fitted[h["lda"].origin_stage.uid]
    check(len(w2v_m.vocab) == 10_000 and len(lda_m.vocab) == 10_000,
          f"the 10 000-word caps bind ({len(w2v_m.vocab)}, {len(lda_m.vocab)})")
    check(np.isfinite(w2v_m.vectors).all() and np.isfinite(lda_m.topic_word).all(),
          "finite embeddings")
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
    summary = model.fitted[sel.uid].summary
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")
    n_pairs = len(kept["w2v"][2])
    steps = emb_counts["skipgram_steps"]

    # Word2Vec's step: launches (the profiler's kernel count) and time
    v_size, dim = len(w2v_m.vocab), int(w2v_m.vectors.shape[1])
    w_in = torch.zeros((v_size, dim), device=dev) + 0.01
    w_out = torch.zeros((v_size, dim), device=dev) + 0.01
    bsz, k_neg = 1024, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    c = torch.randint(0, v_size, (bsz,), device=dev, generator=gen)
    oi = torch.randint(0, v_size, (bsz, 1 + k_neg), device=dev, generator=gen)
    scale = torch.full((bsz,), -1.0 / bsz, device=dev)
    sign = torch.tensor([1.0] + [-1.0] * k_neg, device=dev)
    step = lambda: E.skipgram_step(w_in, w_out, c, oi, scale, sign, 0.05)  # noqa: E731
    step_ms = time_big_ms(step, runs=51, warmup=5)
    step_device_ms = time_device_ms(step)
    kernels_per_step = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof_:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in prof_.events() if e.device_type.name == "CUDA"]
        kernels_per_step = len(kernels) / 10 if kernels else None
    except Exception as e:  # the profiler may not reach the card in the sandbox
        kernels_per_step = f"not measured: {e!r}"[:200]
    step_bytes = (bsz * (1 + (1 + k_neg)) * dim * 4 * 2   # gathers and scattered rows
                  + bsz * (2 + k_neg) * 8)
    step_ops = bsz * (1 + k_neg) * dim * 2 * 3
    step_bound = max(step_bytes / HBM_BYTES_PER_S, step_ops / F32_OPS_PER_S) * 1e3

    # LDA's E-step at the full count matrix: ms an iteration against its bound
    x_full = kept["lda"][0]
    xd = torch.from_numpy(x_full).to(dev)
    lam = torch.from_numpy(lda_m.topic_word).to(dev)
    alpha = 1.0 / lda_m.k
    with full_f32():
        e5 = time_big_ms(lambda: E.e_step(xd, lam, alpha, 5), runs=5, warmup=1)
        e0 = time_big_ms(lambda: E.e_step(xd, lam, alpha, 0), runs=5, warmup=1)
    d_docs, v_words = x_full.shape
    it_bytes = d_docs * v_words * 4
    it_ops = 2 * 2 * d_docs * lda_m.k * v_words
    e_bound = max(it_bytes / HBM_BYTES_PER_S, it_ops / F32_OPS_PER_S) * 1e3
    e_step = {"docs": d_docs, "vocab": v_words, "k": lda_m.k,
              "ms_per_iteration": (e5 - e0) / 5, "ms_5_iterations": e5,
              "ms_0_iterations": e0, "bound_ms": e_bound,
              "bound_by": "bytes" if it_bytes / HBM_BYTES_PER_S >= it_ops / F32_OPS_PER_S
              else "operations",
              "bytes": it_bytes, "operations": it_ops}
    del xd, lam, x_full, kept

    # save -> load -> 16 served batches of 1024
    path = os.path.join("build", "text_model")
    t0s = time.perf_counter()
    model.save(path)
    t1s = time.perf_counter()
    loaded = T.WorkflowModel.load(path)
    t2s = time.perf_counter()
    splan, scpu = loaded.serving_plan(), loaded.serving_plan(device="cpu")
    batches = [TD.make_records(cols, range(i * BATCH, (i + 1) * BATCH))
               for i in range(N_BATCHES)]
    pname = pred.name
    serve_cpu_dev = _records_within(splan.score(batches[0]), scpu.score(batches[0]),
                                    pname, 1e-5)
    torch.cuda.synchronize()
    _reset_all(KE)
    E.reset_launch_counts()
    rows, parts = [], []
    t0b = time.perf_counter()
    for b in batches:
        rows.append(splan.score(b))
        parts.append(dict(splan.last_timings))
    wall = time.perf_counter() - t0b
    launches_serving = _all_counts(KE)
    slots = len(splan._encode_table) if splan._encode_table is not None else 0
    check(slots >= 1 and launches_serving["encode_slots"] == N_BATCHES
          and launches_serving["encode_slots.slots"] == slots * N_BATCHES,
          f"one encode launch of {slots} slots per served batch: {launches_serving}")
    check(E.launch_counts()["lda_e_steps"] == N_BATCHES,
          "LDAModel's E-step ran once per served batch")
    for got in rows:
        for r in got:
            p = r[pname]
            check(all(np.isfinite(v) for v in p.values()), f"finite prediction {p}")

    def med(key):
        return statistics.median(p[key] for p in parts)

    # NER alone: per-token Python, as in the reference
    ner_col = ds["review"].take(np.arange(TEXT_NER_ROWS))
    t0n = time.perf_counter()
    NameEntityRecognizer().transform_columns([ner_col], None)
    ner_s = time.perf_counter() - t0n

    host_fit = sum(v for k, v in by_stage.items()
                   if k not in ("Word2Vec", "LDA", "SanityChecker", "ModelSelector"))
    out["wide"] = {
        "rows": TEXT_ROWS, "train_seconds": seconds,
        "data_host_seconds": {"make_text_s": t1 - t0, "from_features_s": t2 - t1},
        "parts_seconds": {
            "tokenizer": host_by_stage.get("TextTokenizer"),
            "host_stages_without_tokenizer": sum(v for k, v in host_by_stage.items()
                                                 if k != "TextTokenizer"),
            "host_transforms_by_class": host_by_stage,
            "host_stage_fits": host_fit,
            "word2vec_fit": by_stage.get("Word2Vec"),
            "word2vec_pairs": timers.get("w2v_pairs"),
            "word2vec_draws_host": timers.get("w2v_draws"),
            "word2vec_card": timers.get("w2v_card") - timers.get("w2v_draws"),
            "lda_fit": by_stage.get("LDA"),
            "lda_count_matrix": timers.get("lda_count_matrix"),
            "lda_em_card": timers.get("lda_em"),
            "flushes": sum(r["seconds"] for r in flushes),
            "sanity_checker": by_stage.get("SanityChecker"),
            "selector": by_stage.get("ModelSelector")},
        "fit_seconds_by_stage": by_stage,
        "word2vec": {"vocab": v_size, "dim": dim, "pairs": n_pairs, "steps": steps,
                     "epochs": emb_counts["skipgram_epochs"],
                     "steps_per_s": steps / (timers["w2v_card"] - timers["w2v_draws"]),
                     "step_ms": step_ms, "step_device_ms": step_device_ms,
                     "step_bound_ms": step_bound, "kernels_per_step": kernels_per_step},
        "lda_e_step": e_step, "max_memory_allocated_bytes": peak,
        "launches": launches, "hashing_paths": paths,
        "kept": len(model.fitted[chk.uid].kept_indices),
        "winner_grid": summary.best_grid,
        "cv": [{"grid": e.grid, "values": e.metric_values}
               for e in summary.validation_results],
        "save_s": t1s - t0s, "load_s": t2s - t1s,
        "serving": {"batches": N_BATCHES, "batch": BATCH,
                    "records_per_s": N_BATCHES * BATCH / wall,
                    "encode_ms_median": med("encode_ms"),
                    "device_ms_median": med("device_ms"),
                    "host_ms_median": med("host_ms"),
                    "launches": launches_serving, "slots_per_batch": slots,
                    "host_stages": sorted({type(r).__name__ for r in splan._remainder}),
                    "max_abs_dev_cpu_plan": serve_cpu_dev},
        "ner": {"docs": TEXT_NER_ROWS, "ms_per_doc": ner_s / TEXT_NER_ROWS * 1e3}}
    emit({"phase": "text", **out})
    return out


# -- workflow-level CV, ModelInsights and LOCO -------------------------------------

def _wcv_train(torch, ds, schema, dev, wcv: bool):
    """The wide pipeline over ``ds`` with the workflow-CV selector (3 folds,
    LR + MLP; tests/torch_wide_data.py::wcv_models) trained on ``dev``, with
    workflow-level CV or without.  Returns (model, workflow, handles,
    seconds)."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import WCV_FOLDS, wcv_models, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name

    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema, WCV_FOLDS, wcv_models(T))
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    if wcv:
        wf = wf.with_workflow_cv()
    _sync(torch, dev)
    t0 = time.perf_counter()
    model = wf.train(device=dev)
    _sync(torch, dev)
    return model, wf, {"label": label, "sel": sel, "chk": chk, "pred": pred}, \
        time.perf_counter() - t0


class _FoldCapture:
    """Wraps workflow/fit.py's fused_fold_transforms for one train: keeps its
    dataset, ``during`` stages, fold maps and fold datasets."""

    def __init__(self):
        from transmogrifai_tpu_torch.workflow import fit as F

        self.F, self.real, self.seen = F, F.fused_fold_transforms, {}

    def __enter__(self):
        def capture(dataset, during, maps, *a, **kw):
            out = self.real(dataset, during, maps, *a, **kw)
            self.seen.update(dataset=dataset, during=during, maps=maps, out=out)
            return out

        self.F.fused_fold_transforms = capture
        return self

    def __exit__(self, *exc):
        self.F.fused_fold_transforms = self.real


def _record_draws(arrays: dict):
    """The MLP's initial draws from the record (the reference's
    ``jax.random`` draws by network size), as models/mlp.py's seam returns
    them."""
    import torch
    from torch_wide_data import mlp_key

    def draws(sizes, seed, device):
        return [(torch.from_numpy(arrays[mlp_key(sizes, seed, i, "w")].copy()).to(device),
                 torch.from_numpy(arrays[mlp_key(sizes, seed, i, "b")].copy()).to(device))
                for i in range(len(sizes) - 1)]

    return draws


def _tf32_on(torch):
    """A stand-in for ``full_f32`` that lets float32 products use TF32 (the
    MLP control of lower precision)."""
    import contextlib

    @contextlib.contextmanager
    def tf32_on():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return tf32_on


def _fold_table(torch, KE, cap: dict, dev, time_it: bool) -> dict:
    """The fold transform's one launch rebuilt from a captured train: bitwise
    against encode_slots_torch on the card, and with ``time_it`` timed beside
    its bound (each distinct operand read once -- every fold's bucketize
    slots of one raw column read the same tensor -- and n*sum(W_f)*4 bytes
    out, over the card's memory rate), its plain version and the library
    composite."""
    from transmogrifai_tpu_torch.workflow.plan import FoldTransformPlan

    ds = cap["dataset"]
    plan = FoldTransformPlan([[m[s.uid] for s in cap["during"]] for m in cap["maps"]],
                             frozenset(ds.names), dev)
    table, n = plan.table, ds.n_rows
    ins = plan.encode_operands(ds)
    buf = torch.empty((n, -(-table.width // 4) * 4), device=dev)[:, :table.width]
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          f"the fold transform's launch of {len(table)} slots bitwise at {n} rows")
    out = {"rows": n, "folds": len(plan.plans), "slots": len(table),
           "columns": table.width, "chunks": len(table.chunks), "max_abs_err": 0.0}
    if time_it:
        distinct = {id(t): t for t in ins}.values()
        nbytes = sum(t.nbytes for t in distinct) + n * table.width * 4
        out.update({
            "operands": len(ins), "distinct_operands": len(distinct),
            "ms": time_big_ms(lambda: KE.encode_slots(ins, table, buf), runs=21, warmup=3),
            "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_big_ms(lambda: _table_library(torch, ins, table), runs=5),
            "library": "per slot torch.bucketize + torch.nn.functional.one_hot "
                       "(buckets only), then torch.cat"})
    return out


def _split_slots(seen: dict) -> int:
    """Bucketize slots of a captured train's folds: one per fold and
    bucketizer that found a split."""
    return sum(1 for m in seen["maps"] for r in m.values()
               if type(r).__name__ == "DecisionTreeNumericBucketizerModel" and r.should_split)


def _wcv_parts(prof: list) -> dict:
    """Seconds by part of a workflow-CV train's profile: the before fit (the
    records before the first fold's), each fold's fits and flushes, the fold
    transform, each fold's sweep by family, and the refit (the records after
    the last sweep)."""
    first = next(i for i, r in enumerate(prof) if "fold" in r)
    last = max(i for i, r in enumerate(prof) if r["kind"] == "fold_sweep")
    folds: dict = {}
    for r in prof[first:last + 1]:
        if r["kind"] in ("fit", "flush") and "fold" in r:
            part = folds.setdefault(r["fold"], {"bucketizers_s": 0.0, "checker_s": 0.0,
                                                "flushes_s": 0.0, "flush_encode_ms": []})
            if r["kind"] == "flush":
                part["flushes_s"] += r["seconds"]
                if r.get("encode_ms") is not None:
                    part["flush_encode_ms"].append(r["encode_ms"])
            elif r["stage"] == "SanityChecker":
                part["checker_s"] += r["seconds"]
            else:
                part["bucketizers_s"] += r["seconds"]
    [ft] = [r for r in prof if r["kind"] == "fold_transform"]
    sweeps = [r for r in prof if r["kind"] == "fold_sweep"]
    return {"before_s": sum(r["seconds"] for r in prof[:first]),
            "before_fits": sum(r["kind"] == "fit" for r in prof[:first]),
            "folds": [folds[f] for f in sorted(folds)],
            "fold_transform": {k: ft.get(k) for k in (
                "seconds", "plans", "encode_slots", "encode_width", "encode_launches",
                "encode_ms", "host_encode_s", "device_s", "d2h_s", "host_stages_s",
                "h2d_copies", "h2d_bytes", "d2h_bytes")},
            "fold_sweeps": [{"fold": r["fold"], "seconds": r["seconds"],
                             "width": r["width"], "family_seconds": r["family_seconds"]}
                            for r in sweeps],
            "refit_s": sum(r["seconds"] for r in prof[last + 1:])}


def phase_workflow_cv(torch, KE, dev) -> dict:
    """Workflow-level CV, ModelInsights and LOCO on the card: (a) the
    record's 8192-row train against fixtures/workflow_cv; (b) the train at
    WCV_ROWS by part beside the same train without workflow CV; (c) LOCO
    over WCV_LOCO_ROWS served records and model_insights()."""
    import numpy as np

    import transmogrifai_tpu_torch as T
    from torch_wide_data import (
        WCV_MLP_GRIDS,
        fold_states,
        insights_deviation,
        loco_deviation,
        make_data,
        mlp_fold_cv,
        split_family_cv,
    )
    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.insights.model_insights import _json_default
    from transmogrifai_tpu_torch.models import mlp as TM
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.plan import fused_fold_transforms

    def plain(d):
        return json.loads(json.dumps(d, default=_json_default))

    with open(os.path.join(WCV_FIXTURE, "states.json")) as fh:
        states = json.load(fh)
    with np.load(os.path.join(WCV_FIXTURE, "mlp_init.npz")) as npz:
        draws = {k: npz[k] for k in npz.files}

    # (a) parity with the record at its rows, the MLP's draws fed from it
    t0 = time.perf_counter()
    cols, schema = make_data(states["rows"], seed=states["seed"], **states["shape"])
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    own_draws = TM.draw_mlp_init
    TM.draw_mlp_init = _record_draws(draws)
    try:
        KE.reset_launch_counts()
        with _FoldCapture() as cap:
            model, wf, h, seconds_a = _wcv_train(torch, ds, schema, dev, wcv=True)
        launches_a = KE.launch_counts()
    finally:
        TM.draw_mlp_init = own_draws
    seen = cap.seen
    folds = fold_states(seen["maps"], seen["out"], h["sel"].inputs[1].name)
    for f, (g, w) in enumerate(zip(folds, states["folds"])):
        check(g["splits"] == w["splits"], f"fold {f}: bucketizer splits equal to the record")
        check(g["kept"] == w["kept"], f"fold {f}: kept indices equal to the record")
        check(g["vector"] == w["vector"], f"fold {f}: vector sha256 equal to the record")
    check(len(folds) == len(states["folds"]) == 3, "3 folds")
    summary = model.summary()
    cv_dev = {}
    for ev, r in zip(summary.validation_results, states["cv"]):
        grid = {k: list(v) if isinstance(v, tuple) else v for k, v in ev.grid.items()}
        check((ev.model_name, grid) == (r["model"], r["grid"]), f"CV row {r['model']}")
        d = float(np.max(np.abs(np.asarray(ev.metric_values) - np.asarray(r["values"]))))
        cv_dev[ev.model_name] = max(cv_dev.get(ev.model_name, 0.0), d)
    check(len(summary.validation_results) == len(states["cv"]), "every CV row")
    check(cv_dev["LogisticRegression"] <= 1e-4, f"LR CV within 1e-4 ({cv_dev})")
    check(cv_dev["MultilayerPerceptronClassifier"] <= WCV_MLP_TOL,
          f"MLP CV within {WCV_MLP_TOL} ({cv_dev})")
    win = states["winner"]
    check((summary.best_model_name, summary.best_grid) == (win["name"], win["grid"]),
          f"winner {summary.best_model_name} {summary.best_grid} == the record's")
    got_win = model.selector_model().model
    coef_dev = float(np.max(np.abs(np.asarray(got_win.coef) - np.asarray(win["coef"]))))
    check(np.allclose(got_win.coef, win["coef"], rtol=1e-4, atol=1e-5)
          and np.isclose(got_win.intercept, win["intercept"], rtol=1e-4, atol=1e-5),
          f"refit coefficients within rtol 1e-4 / atol 1e-5 ({coef_dev})")
    [ft_a] = [r for r in wf.last_train_profile if r["kind"] == "fold_transform"]
    check(ft_a["encode_launches"] == 1 and ft_a["encode_slots"] == _split_slots(seen) == 24,
          f"the fold transform: one launch of 3 x 8 slots ({ft_a})")
    table_a = _fold_table(torch, KE, seen, dev, time_it=False)
    cpu_folds = fused_fold_transforms(seen["dataset"], seen["during"], seen["maps"],
                                      torch.device("cpu"))
    vec_name = h["sel"].inputs[1].name
    for f, (c, p) in enumerate(zip(seen["out"], cpu_folds)):
        check(c[vec_name].data.tobytes() == p[vec_name].data.tobytes(),
              f"fold {f}'s vector on the card bitwise the CPU plan's")
    jax_model = T.WorkflowModel.load(WCV_FIXTURE)
    with open(os.path.join(WCV_FIXTURE, "insights.json")) as fh:
        want_ins = json.load(fh)
    ins_dev = insights_deviation(want_ins, plain(jax_model.model_insights().to_dict()))
    check(ins_dev <= 1e-6, f"the JAX-saved model's insights equal the record ({ins_dev})")
    got_ins = plain(model.model_insights().to_dict())
    got_ins["stageInfo"] = sorted(v["class"] for v in got_ins["stageInfo"].values())
    want_cmp = dict(want_ins, stageInfo=sorted(v["class"]
                                               for v in want_ins["stageInfo"].values()))
    # its selection summary carries the MLP's CV metrics: held as the CV is
    want_rest, want_mlp = split_family_cv(want_cmp, "MultilayerPerceptronClassifier")
    got_rest, got_mlp = split_family_cv(got_ins, "MultilayerPerceptronClassifier")
    ins_seen: list = []
    trained_ins_dev = insights_deviation(want_rest, got_rest, frozenset({"bestModelUID"}),
                                         seen=ins_seen)
    trained_ins_worst = sorted(ins_seen, reverse=True)[:5]
    check(trained_ins_dev <= WCV_TRAINED_INSIGHTS_TOL,
          f"the card-trained model's insights within {WCV_TRAINED_INSIGHTS_TOL} of the "
          f"record, the MLP's CV entries aside ({trained_ins_worst})")
    trained_mlp_dev = float(np.max(np.abs(np.subtract(got_mlp, want_mlp))))
    check(len(got_mlp) == len(want_mlp) > 0 and trained_mlp_dev <= WCV_MLP_TOL,
          f"its MLP CV entries within {WCV_MLP_TOL} ({trained_mlp_dev})")
    # the control: the MLP swept again on the run's fold vectors with TF32 on
    want_cv = [r["values"] for r in states["cv"]
               if r["model"] == "MultilayerPerceptronClassifier"]
    own_f32 = TM.full_f32
    TM.draw_mlp_init, TM.full_f32 = _record_draws(draws), _tf32_on(torch)
    try:
        tf32_cv = mlp_fold_cv(h["sel"], seen["out"], dev)
    finally:
        TM.draw_mlp_init, TM.full_f32 = own_draws, own_f32
    tf32_dev = float(np.max(np.abs(tf32_cv - np.asarray(want_cv))))
    with open(os.path.join(WCV_FIXTURE, "loco.json")) as fh:
        rec = json.load(fh)
    vec = jax_model.score(ds.take(np.arange(rec["rows"])), keep_intermediate=True,
                          device=dev)[rec["vector"]]
    loco_dev = {}
    for strategy in ("abs", "positive"):
        t = RecordInsightsLOCO(jax_model.selector_model(), top_k=rec[strategy]["top_k"],
                               strategy=strategy, device=dev)
        got = t.transform_columns([vec], None)
        loco_dev[strategy] = loco_deviation(rec[strategy]["rows"], list(got.data), strategy)
        check(loco_dev[strategy] <= 1e-9,
              f"LOCO ({strategy}) of the JAX-saved model within 1e-9 of the record "
              f"({loco_dev[strategy]})")
    parity = {"rows": states["rows"], "train_seconds": seconds_a,
              "phase_seconds": time.perf_counter() - t0, "cv_max_abs_dev": cv_dev,
              "coef_max_abs_dev": coef_dev, "insights_rel_dev": ins_dev,
              "trained_insights_rel_dev": trained_ins_dev,
              "trained_insights_worst": trained_ins_worst,
              "trained_insights_differing": len(ins_seen),
              "trained_insights_mlp_cv_dev": trained_mlp_dev,
              "mlp_cv_tf32_control_dev": tf32_dev, "loco_max_abs_dev": loco_dev,
              "launches": launches_a, "fold_transform": table_a}
    del model, wf, cap, seen, cpu_folds, jax_model, ds, cols

    # (b) the train at WCV_ROWS by part, beside the same train without
    # workflow CV
    t0 = time.perf_counter()
    cols, schema = make_data(WCV_ROWS, seed=0, **states["shape"])
    ds = T.Dataset.from_features(cols, {s["name"]: feature_type_by_name(s["type"])
                                        for s in schema})
    del cols
    data_s = time.perf_counter() - t0
    _, _, _, plain_seconds = _wcv_train(torch, ds, schema, dev, wcv=False)
    torch.cuda.reset_peak_memory_stats()
    KE.reset_launch_counts()
    with _FoldCapture() as cap:
        model, wf, h, seconds = _wcv_train(torch, ds, schema, dev, wcv=True)
    launches = KE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    parts = _wcv_parts(wf.last_train_profile)
    ft = parts["fold_transform"]
    check(ft["encode_launches"] == 1 and ft["encode_slots"] == _split_slots(cap.seen) > 3,
          f"the fold transform at {WCV_ROWS} rows: one launch of every fold's "
          f"bucketize slots ({ft})")
    check(launches["encode_slots"] >= 1 and launches["onehot_codes"] == 0
          and launches["bucketize_right_encode"] == 0,
          f"the workflow-CV train launches the encode kernel: {launches}")
    summary = model.summary()
    for e in summary.validation_results:
        check(all(np.isfinite(v) for v in e.metric_values), f"finite CV {e}")
    table = _fold_table(torch, KE, cap.seen, dev, time_it=True)
    table["in_train_ms"] = ft["encode_ms"]
    mlp_s = [r["family_seconds"].get("MultilayerPerceptronClassifier") for r
             in parts["fold_sweeps"]]
    steps = 200 * len(WCV_MLP_GRIDS)   # max_iter Adam steps a grid point, folds batched
    timed = {"rows": WCV_ROWS, "train_seconds": seconds, "plain_train_seconds": plain_seconds,
             "data_host_seconds": data_s, "parts_seconds": parts,
             "mlp_adam_steps_per_s": [steps / s for s in mlp_s if s],
             "launches": launches, "max_memory_allocated_bytes": peak,
             "winner": summary.best_model_name, "winner_grid": summary.best_grid,
             "cv": [{"model": e.model_name, "grid": e.grid, "values": e.metric_values}
                    for e in summary.validation_results],
             "fold_transform": table}
    del cap

    # (c) LOCO over served records of that model, and its insights
    scored = model.score(ds.take(np.arange(WCV_LOCO_ROWS)), keep_intermediate=True,
                         device=dev)
    loco = RecordInsightsLOCO(model.selector_model(), device=dev)
    t1 = time.perf_counter()
    out = loco.transform_columns([scored[h["sel"].inputs[1].name]], None)
    loco_s = time.perf_counter() - t1
    check(len(out) == WCV_LOCO_ROWS and all(0 < len(m) <= 20 for m in out.data),
          "LOCO: 1..20 entries for every record")
    check(all(np.isfinite(v).all() for m in out.data[:64]
              for v in RecordInsightsLOCO.parse(m).values()), "finite LOCO diffs")
    t1 = time.perf_counter()
    ins = model.model_insights()
    insights_s = time.perf_counter() - t1
    check(len(ins.features) > 0 and ins.selected_model_info["bestModelName"]
          == summary.best_model_name, "model_insights() of the trained model")
    timed["loco"] = {"rows": WCV_LOCO_ROWS, **loco.last_profile, "seconds": loco_s,
                     "records_per_s": WCV_LOCO_ROWS / loco_s}
    timed["model_insights_seconds"] = insights_s
    emit({"phase": "workflow_cv", "parity": parity, **timed})
    return {"parity": parity, **timed}


# -- 21. streaming: Spark-free scoring, streaming, continual refit, resume -------

STREAM_BATCH = 1024
#: records of the parity stream (8 micro-batches) and of the timed one
STREAM_PARITY_RECORDS = 8 * STREAM_BATCH
STREAM_RECORDS = 65536
#: the continual loop: train rows, labelled records streamed (the second
#: half shifted by CONT_SHIFT standard deviations on a quarter of the Reals)
CONT_TRAIN_ROWS = 65536
CONT_STREAM_RECORDS = 131072
CONT_SHIFTED_REALS = 16
CONT_SHIFT = 3.0
#: the example's (examples/serving_streaming.py) selector grids
CONT_GBT_GRID = {"num_rounds": 20, "max_depth": 3}
#: bench.py's 4-family sweep, resumed
RESUME_ROWS = 262144
STREAM_RECORD = os.path.join("transmogrifai_tpu_torch", "fixtures", "streaming")


def make_records_fast(schema: dict, n: int, rng) -> list:
    """Requests drawn like :func:`make_records` (missing, unseen, absent
    fields) column by column with numpy, for record counts where the
    per-field loop would take minutes."""
    import numpy as np

    feats = [f for f in schema["features"] if not f.get("response")]
    cols = []
    for f in feats:
        u = rng.random(n)
        if f["type"] == "Real":
            v = rng.normal(size=n).tolist()
        elif f["type"] == "Binary":
            v = (rng.random(n) < 0.3).tolist()
        else:
            lv = np.asarray(f["levels"])[rng.integers(len(f["levels"]), size=n)]
            unseen = rng.integers(1000, size=n)
            v = [f"unseen{k}" if x < 0.15 else str(s)
                 for x, s, k in zip(u.tolist(), lv.tolist(), unseen.tolist())]
        cols.append((f["name"], u.tolist(), v))
    out = [{} for _ in range(n)]
    for name, u, v in cols:
        for r, x, val in zip(out, u, v):
            if x >= 0.1:
                r[name] = val
            elif x >= 0.02:
                r[name] = None
    return out


def _write_jsonl(path: str, records) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")


def _stream_score(events: str, offsets: str, out_dir: str, model_dir: str):
    """STREAMING_SCORE of ``events`` through the port's runner in
    micro-batches of STREAM_BATCH, offsets committed to ``offsets``;
    returns (RunResult, reader)."""
    from transmogrifai_tpu_torch import Workflow
    from transmogrifai_tpu_torch.params import OpParams
    from transmogrifai_tpu_torch.readers import (JsonlTailSource,
                                                 MicroBatchStreamingReader,
                                                 OffsetCheckpoint)
    from transmogrifai_tpu_torch.workflow.runner import RunType, WorkflowRunner

    reader = MicroBatchStreamingReader(
        JsonlTailSource(events), OffsetCheckpoint(offsets), batch_interval=0.0,
        max_batch_records=STREAM_BATCH, min_batch_records=STREAM_BATCH,
        max_empty_polls=0, sleep=lambda s: None)
    runner = WorkflowRunner(workflow=Workflow(), streaming_reader=reader)
    res = runner.run(RunType.STREAMING_SCORE, OpParams(
        model_location=model_dir, write_location=os.path.join(out_dir, "s.csv")))
    return res, reader


def _pred_parts(col) -> tuple:
    import numpy as np

    return tuple(np.asarray(getattr(col, p)).tobytes() for p in ("pred", "raw", "prob"))


def _stream_parity(torch, KE, dev, schema: dict, tmp: str) -> dict:
    """(a) the fixture's records streamed in micro-batches on the card, each
    batch equal to the CPU plan's; offsets exact; score_function equal to
    model.score; the exported bundle within 1e-6 of LocalScorer."""
    import numpy as np

    import torch_stream_data as S
    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.local import LocalScorer, export_standalone
    from transmogrifai_tpu_torch.local.scoring import _plain
    from transmogrifai_tpu_torch.readers import (JsonlTailSource,
                                                 MicroBatchStreamingReader,
                                                 OffsetCheckpoint)
    from transmogrifai_tpu_torch.readers.base import rows_to_dataset
    from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

    records = make_records(schema, STREAM_PARITY_RECORDS, np.random.default_rng(21))
    events, offsets = os.path.join(tmp, "parity.jsonl"), os.path.join(tmp, "parity.offsets")
    _write_jsonl(events, records)
    cpu_model = WorkflowModel.load(FIXTURE)
    raws = dedup_raw_features(cpu_model.result_features)
    pred = next(f.name for f in cpu_model.result_features
                if f.ftype.__name__ == "Prediction")
    _reset_all(KE)
    res, reader = _stream_score(events, offsets, os.path.join(tmp, "parity_out"), FIXTURE)
    launches = _all_counts(KE)
    n_batches = STREAM_PARITY_RECORDS // STREAM_BATCH
    check(res.metrics["batches"] == n_batches
          and [b.n_rows for b in res.scores] == [STREAM_BATCH] * n_batches,
          f"{n_batches} micro-batches of {STREAM_BATCH}: {res.metrics}")
    on_card = dev.type == "cuda"   # (a CPU rehearsal launches no kernel)
    check(not on_card or launches["encode_slots"] == n_batches
          and launches["encode_slots.slots"] == 40 * n_batches
          and launches["onehot_codes"] == launches["bucketize_right_encode"] == 0,
          f"one encode launch of 40 slots per micro-batch: {launches}")
    for i, got in enumerate(res.scores):
        chunk = records[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
        want = cpu_model.score(rows_to_dataset(chunk, raws, allow_missing_response=True),
                               device="cpu")
        check(_pred_parts(got[pred]) == _pred_parts(want[pred]),
              f"micro-batch {i}: the card's scores bitwise the CPU plan's")
    size = os.path.getsize(events)
    with open(offsets) as fh:
        committed = json.load(fh)[JsonlTailSource(events).source_id]
    check(committed == size, f"committed offset {committed} == the file's {size} bytes")
    again = MicroBatchStreamingReader(JsonlTailSource(events), OffsetCheckpoint(offsets),
                                      batch_interval=0.0, max_empty_polls=0,
                                      sleep=lambda s: None)
    check(list(again.stream_datasets(raws)) == [], "a restarted reader replays nothing")

    card_model = WorkflowModel.load(FIXTURE)
    scorer = LocalScorer(card_model)
    check(scorer.device == dev, "score_function binds to the default device (the card)")
    ds = rows_to_dataset(records[:STREAM_BATCH], raws, allow_missing_response=True)
    local = scorer.batch(records[:STREAM_BATCH])
    want = [_plain(v) for v in card_model.score(ds, device=dev)[pred].to_values()]
    check([r[pred] for r in local] == want,
          "score_function's records == model.score on the card")
    try:
        export_standalone(card_model, os.path.join(tmp, "wide_bundle"))
        refused = None
    except ValueError as e:
        refused = str(e)
    with open(os.path.join(STREAM_RECORD, "export_refusals.json")) as fh:
        check(refused == json.load(fh)["serving_wide"],
              f"serving_wide's export refused as the JAX package refuses it: {refused}")
    fam = WorkflowModel.load(FAMILIES_FIXTURE)
    with open(os.path.join(FAMILIES_FIXTURE, "records.json")) as fh:
        fam_recs = [r for b in json.load(fh)["batches"] for r in b["records"]]
    fam_pred = next(f.name for f in fam.result_features if f.ftype.__name__ == "Prediction")
    bundle = os.path.join(tmp, "families_bundle")
    export_standalone(fam, bundle)
    fam_local = LocalScorer(fam).batch(fam_recs)
    out = S.run_bundle(bundle, fam_recs, batch=len(fam_recs))
    check(out["loaded"] == [], f"the bundle's process loaded {out['loaded']}")
    bundle_dev = S.bundle_deviation(out["rows"], fam_local, fam_pred)
    check(bundle_dev <= 1e-6, f"the bundle within 1e-6 of LocalScorer on the card ({bundle_dev})")
    return {"records": STREAM_PARITY_RECORDS, "batches": n_batches,
            "launches": launches, "committed_offset": committed, "file_bytes": size,
            "records_equal_cpu": True, "score_function_equal_score": True,
            "serving_wide_export": "refused (DecisionTreeNumericBucketizer), as the "
                                   "JAX package refuses it",
            "bundle_model": "fixtures/training_families", "bundle_rows": len(fam_recs),
            "bundle_max_abs_dev": bundle_dev}


def _stream_timed(torch, KE, dev, schema: dict, tmp: str) -> dict:
    """(b) 65 536 records streamed at full width, by part; LocalScorer's
    latency of one record and records/s at 1024; the bundle's records/s."""
    import numpy as np

    import torch_stream_data as S
    import transmogrifai_tpu_torch.readers.streaming as RS
    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.local import LocalScorer, export_standalone
    from transmogrifai_tpu_torch.workflow import plan as WP
    from transmogrifai_tpu_torch.workflow import runner as WR

    t0 = time.perf_counter()
    records = make_records_fast(schema, STREAM_RECORDS, np.random.default_rng(22))
    events = os.path.join(tmp, "timed.jsonl")
    _write_jsonl(events, records)
    make_s = time.perf_counter() - t0
    parts = {"read_parse_s": 0.0, "extract_s": 0.0, "host_encode_s": 0.0,
             "device_prefix_s": 0.0, "encode_launch_ms": 0.0, "head_s": 0.0,
             "write_s": 0.0, "commit_s": 0.0}
    launches_per_batch = []
    # time the parts by wrapping the functions each micro-batch goes through
    saved = [(RS.JsonlTailSource, "poll"), (RS, "rows_to_dataset"),
             (WP.JointPrefix, "apply_prefix"), (WP, "run_host_stages"),
             (WR, "_write_dataset"), (RS.OffsetCheckpoint, "commit")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[key] += time.perf_counter() - t
        return run

    real_apply = WP.JointPrefix.apply_prefix

    def apply_prefix(self, *a, **k):
        before = KE.encode_slots_launches
        out = real_apply(self, *a, **k)
        launches_per_batch.append(KE.encode_slots_launches - before)
        tm = self.last_timings
        parts["host_encode_s"] += tm["host_encode_s"] + tm["columns_s"]
        parts["device_prefix_s"] += tm["h2d_s"] + tm["device_s"] + tm["d2h_s"]
        parts["encode_launch_ms"] += tm["encode_ms"] or 0.0
        return out

    RS.JsonlTailSource.poll = timed("read_parse_s", RS.JsonlTailSource.poll)
    RS.rows_to_dataset = timed("extract_s", RS.rows_to_dataset)
    WP.JointPrefix.apply_prefix = apply_prefix
    WP.run_host_stages = timed("head_s", WP.run_host_stages)
    WR._write_dataset = timed("write_s", WR._write_dataset)
    RS.OffsetCheckpoint.commit = timed("commit_s", RS.OffsetCheckpoint.commit)
    try:
        _sync(torch, dev)
        t0 = time.perf_counter()
        res, reader = _stream_score(events, os.path.join(tmp, "timed.offsets"),
                                    os.path.join(tmp, "timed_out"), FIXTURE)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        for o, n, f in saved:
            setattr(o, n, f)
    parts["other_s"] = wall - sum(v for k, v in parts.items() if k.endswith("_s"))
    n_batches = res.metrics["batches"]
    check(n_batches == STREAM_RECORDS // STREAM_BATCH
          and launches_per_batch == [int(dev.type == "cuda")] * n_batches,
          f"one encode launch per micro-batch: {launches_per_batch[:8]}...")
    # LocalScorer: one record, then batches of 1024
    model = WorkflowModel.load(FIXTURE)
    scorer = LocalScorer(model)
    for r in records[:20]:
        scorer(r)
    lat = []
    for r in records[:300]:
        t = time.perf_counter()
        scorer(r)
        lat.append(1e3 * (time.perf_counter() - t))
    batches = [records[i:i + STREAM_BATCH] for i in range(0, 16 * STREAM_BATCH, STREAM_BATCH)]
    scorer.batch(batches[0])
    _sync(torch, dev)
    t0 = time.perf_counter()
    for b in batches:
        scorer.batch(b)
    _sync(torch, dev)
    local_rps = 16 * STREAM_BATCH / (time.perf_counter() - t0)
    # the bundle (the families model: serving_wide's is refused) at 1024
    fam = WorkflowModel.load(FAMILIES_FIXTURE)
    with open(os.path.join(FAMILIES_FIXTURE, "records.json")) as fh:
        fam_recs = [r for b in json.load(fh)["batches"] for r in b["records"]]
    bundle = os.path.join(tmp, "families_bundle_timed")
    export_standalone(fam, bundle)
    many = (fam_recs * (16 * STREAM_BATCH // len(fam_recs) + 1))[:16 * STREAM_BATCH]
    out = S.run_bundle(bundle, many, batch=STREAM_BATCH)
    fam_scorer = LocalScorer(fam)
    fam_scorer.batch(many[:STREAM_BATCH])
    _sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(0, len(many), STREAM_BATCH):
        fam_scorer.batch(many[i:i + STREAM_BATCH])
    _sync(torch, dev)
    fam_local_rps = len(many) / (time.perf_counter() - t0)
    return {"records": STREAM_RECORDS, "batches": n_batches,
            "records_per_s": STREAM_RECORDS / wall, "wall_s": wall,
            "parts": parts, "make_records_and_jsonl_s": make_s,
            "encode_launches_per_batch": 1,
            "local_scorer": {"p50_ms": float(np.percentile(lat, 50)),
                             "p99_ms": float(np.percentile(lat, 99)),
                             "records_per_s_at_1024": local_rps},
            "bundle": {"model": "fixtures/training_families",
                       "records_per_s_at_1024": len(many) / out["seconds"],
                       "local_scorer_records_per_s_at_1024": fam_local_rps}}


def _continual_data(n_train: int, n_stream: int):
    """Phase 10's raw table at ``n_train`` rows and ``n_stream`` labelled
    records of the same maker (another seed) with the second half shifted by
    CONT_SHIFT on the first CONT_SHIFTED_REALS Reals."""
    from torch_wide_data import FIXTURE_SHAPE, make_data

    cols, schema = make_data(n_train, seed=31, **FIXTURE_SHAPE)
    scols, _ = make_data(n_stream, seed=32, **FIXTURE_SHAPE)
    names = list(scols)
    records = [dict(zip(names, row)) for row in zip(*(scols[k] for k in names))]
    shifted = [f"r{j}" for j in range(CONT_SHIFTED_REALS)]
    for r in records[n_stream // 2:]:
        for k in shifted:
            if r[k] is not None:
                r[k] += CONT_SHIFT
    return cols, schema, records


def _continual(torch, KE, dev, tmp: str) -> dict:
    """(c) train at CONT_TRAIN_ROWS on the card; stream CONT_STREAM_RECORDS
    labelled records behind ScoringServer; drift fires; the warm refit on a
    65 536-record window with the prefix frozen builds nothing and launches
    K1-K3 (the GBT); the candidate shadows, is promoted, and a breaker trip
    inside probation rolls the server back."""
    import threading

    import transmogrifai_tpu_torch as T
    from torch_wide_data import wide_pipeline
    from transmogrifai_tpu_torch.models.trees import GradientBoostedTreesClassifier
    from transmogrifai_tpu_torch.perf import compile_snapshot
    from transmogrifai_tpu_torch.readers import ListSource, MicroBatchStreamingReader
    from transmogrifai_tpu_torch.serve import (CircuitOpenError, FaultHarness,
                                               ScoringServer, TransientScoringError)
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow import continual as C
    from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

    t0 = time.perf_counter()
    cols, schema, records = _continual_data(CONT_TRAIN_ROWS, CONT_STREAM_RECORDS)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    del cols
    data_s = time.perf_counter() - t0
    label, sel, chk, pred = wide_pipeline(
        T, ftypes, schema, num_folds=3,
        models=[(T.LogisticRegression(), [{"reg_param": 0.01}]),
                (GradientBoostedTreesClassifier(), [dict(CONT_GBT_GRID)])])
    _sync(torch, dev)
    t0 = time.perf_counter()
    model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred).train(device=dev)
    _sync(torch, dev)
    train_s = time.perf_counter() - t0
    raws = dedup_raw_features(model.result_features)
    snap = C.TrainingSnapshot.from_dataset(ds, features=raws)
    del ds
    server = ScoringServer(model, max_batch=STREAM_BATCH, max_wait_ms=2.0,
                           max_queue=1 << 16,
                           resilience={"max_retries": 0, "failure_threshold": 2,
                                       "recovery_batches": 8})
    plan_compiles0 = server.plan.metrics()["compile_count"]
    refit = C.RefitController(model, sleep=lambda s: None)
    window = {}
    real_refit = refit.refit
    # a side client: closed-loop requests (64 outstanding) while the refit
    # runs, to read the records/s the server keeps serving meanwhile (the
    # loop itself waits for the refit, as the reference's does)
    side = [{k: v for k, v in r.items() if k != "label"} for r in records[:4096]]
    done_at = []

    def client(stop):
        i, pending = 0, []
        while not stop.is_set():
            pending.append(server.submit(side[i % len(side)]))
            i += 1
            if len(pending) >= 64:
                pending.pop(0).result(timeout=120)
                done_at.append(time.perf_counter())
        for f in pending:
            f.result(timeout=120)
            done_at.append(time.perf_counter())

    def refit_timed(win):
        window["compiles0"] = compile_snapshot()
        window["plan_compiles0"] = server.plan.metrics()["compile_count"]
        _reset_all(KE)
        stop = threading.Event()
        th = threading.Thread(target=client, args=(stop,), daemon=True)
        window["t0"] = time.perf_counter()
        th.start()
        try:
            return real_refit(win)
        finally:
            _sync(torch, dev)
            window["t1"] = time.perf_counter()
            window["launches"] = _all_counts(KE)
            # the refit runs on this thread; the server's batches launch
            # the encode kernel on its own threads meanwhile
            window["refit_encode_launches"] = KE.thread_encode_launches()
            stop.set()
            th.join(timeout=300)
            window["side_client_done"] = not th.is_alive()
            window["rows"] = win.n_rows
            window["plan_compiles1"] = server.plan.metrics()["compile_count"]

    refit.refit = refit_timed
    reader = MicroBatchStreamingReader(ListSource(records, "labelled"), batch_interval=0.0,
                                       max_batch_records=STREAM_BATCH,
                                       min_batch_records=STREAM_BATCH, max_empty_polls=0,
                                       sleep=lambda s: None)
    trainer = C.ContinualTrainer(server, model, reader, snapshot=snap, refit=refit,
                                 window_records=CONT_TRAIN_ROWS,
                                 probation_batches=1 << 30)
    t0 = time.perf_counter()
    metrics = trainer.run()
    _sync(torch, dev)
    stream_s = time.perf_counter() - t0
    check(window.get("side_client_done", False), "the side client finished")
    codes = [d.code for d in trainer.diagnostics]
    last = trainer.last_refit
    check(metrics["drift_events"] >= 1 and ("TM801" in codes or "TM802" in codes),
          f"drift fired: {metrics['drift_events']} events, codes {sorted(set(codes))}")
    check(metrics["refits"] == 1 and last is not None, f"one warm refit: {metrics}")
    check(window["rows"] == CONT_TRAIN_ROWS, f"the refit window holds {window['rows']} rows")
    check(last.backend_compiles == 0 and last.prefix_reused,
          f"the refit built or loaded {last.backend_compiles} kernels, prefix reused "
          f"{last.prefix_reused}")
    check("TM809" not in codes, "no TM809")
    since = compile_snapshot().minus(window["compiles0"]).events
    builds = {"builds": since.get("nvcc_build", 0), "loads": since.get("library_load", 0)}
    for k in ("hist_level", "split_scan", "row_select_lanes"):
        check(dev.type != "cuda" or window["launches"][k] > 0,
              f"the refit's GBT launched {k}")
    check(window["plan_compiles1"] == window["plan_compiles0"],
          "the serving plan allocated nothing during the refit")
    flushes = [r for r in refit.last_train_profile if r["kind"] == "flush"]
    encoded = [r for r in flushes if r.get("encode_slots")]
    check(dev.type != "cuda" or (
        encoded and all(r["encode_launches"] == 1 for r in encoded)
        and sum(r.get("encode_launches", 0) for r in flushes)
        == window["refit_encode_launches"] == len(encoded)),
          f"the refit's own encode launches: one a flush with slots "
          f"({[r.get('encode_launches') for r in flushes]} in {len(flushes)} flushes, "
          f"{window['refit_encode_launches']} on the refit's thread)")
    check(metrics["promotions"] == 1 and metrics["swap"]["swaps"] == 1
          and metrics["swap"]["history"][0]["shared_prefix"] is True,
          f"the candidate shadowed and was promoted with the shared prefix: {metrics['swap']}")
    check(metrics["record_errors"] == 0, "no record failed while streaming")
    check(server.in_probation(), "still in probation at the stream's end")
    harness = FaultHarness(seed=0)
    harness.script("device", [TransientScoringError("dead"), TransientScoringError("dead")])
    probe = [{k: v for k, v in r.items() if k != "label"} for r in records[-4:]]
    with harness:
        for r in probe[:3]:
            try:
                server.score(r, timeout=60)
            except (TransientScoringError, CircuitOpenError):
                pass   # the card plan has no host path: the batch fails
    swap = server.swap_metrics()
    check(swap["rollbacks"] == 1 and swap["active_version"] == 1,
          f"the breaker trip in probation rolled back: {swap}")
    trainer._tick()
    check("TM808" in [d.code for d in trainer.diagnostics], "TM808 recorded")
    check(trainer._model is model, "the control plane back on the base model")
    served = server.score(probe[3], timeout=60)
    check(pred.name in served, "the rolled-back model serves")
    server.close()
    in_refit = sum(1 for t in done_at if t <= window["t1"])
    refit_s = window["t1"] - window["t0"]
    prof = refit.last_train_profile
    return {"train_rows": CONT_TRAIN_ROWS, "stream_records": CONT_STREAM_RECORDS,
            "data_s": data_s, "train_s": train_s, "stream_s": stream_s,
            "stream_records_per_s": CONT_STREAM_RECORDS / stream_s,
            "side_client_records": len(done_at),
            "codes": sorted(set(codes)), "counters": trainer.counters,
            "refit": {"rows": window["rows"], "seconds": refit_s,
                      "result_seconds": last.seconds,
                      "kernel_builds_loads": builds, "backend_compiles": last.backend_compiles,
                      "prefix_reused": last.prefix_reused,
                      "serving_plan_compile_count": [window["plan_compiles0"],
                                                     window["plan_compiles1"]],
                      "launches": window["launches"],
                      "launches_note": "the refit's K1-K3; the encode kernel's "
                                       "global count holds the server's batches "
                                       "during the refit too",
                      "encode_launches": window["refit_encode_launches"],
                      "encode_flushes": len(encoded),
                      "parts": [{k: r.get(k) for k in ("kind", "stage", "seconds",
                                                       "encode_launches")}
                                for r in prof],
                      "served_records_per_s_during_refit": in_refit / refit_s},
            "serving_plan_compile_count_start": plan_compiles0,
            "swap": {k: swap[k] for k in ("swaps", "rollbacks", "active_version")},
            "shared_prefix": metrics["swap"]["history"][0]["shared_prefix"]}


def _resume_workflow(x, y):
    import numpy as np

    from transmogrifai_tpu_torch import (BinaryClassificationModelSelector,
                                         FeatureBuilder, Workflow)
    from transmogrifai_tpu_torch.data.dataset import Column, Dataset
    from transmogrifai_tpu_torch.types import RealNN

    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    vec = FeatureBuilder.OPVector("features").extract_field().as_predictor()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=FOLDS, seed=SELECTOR_SEED)
    pred = label.transform_with(selector, vec)
    ds = Dataset({"label": Column(RealNN, y.astype(np.float64),
                                  np.ones(len(y), dtype=np.bool_)),
                  "features": Column.vector(x)})
    return Workflow().set_input_dataset(ds).set_result_features(label, pred), selector


def _winner_arrays(model, selector) -> dict:
    import numpy as np

    win = model.fitted[selector.uid].model
    if hasattr(win, "trees"):
        return {k: np.asarray(v).tobytes() for k, v in win.trees.items()}
    return {"coef": np.asarray(win.coef).tobytes(), "intercept": repr(win.intercept)}


def _resume(torch, KE, dev, tmp: str) -> dict:
    """(d) the 4-family sweep killed at the third family's device sync and
    resumed: 2 journal hits, the replayed families launch nothing, the model
    bitwise an uninterrupted run's; an out-of-memory at the GBT's launch
    degrades it to the next row bucket and commits nothing for it."""
    import numpy as np

    from transmogrifai_tpu_torch.models import base as MB
    from transmogrifai_tpu_torch.serve import FaultHarness
    from transmogrifai_tpu_torch.workflow import resilience
    from transmogrifai_tpu_torch.workflow.resilience import SweepJournal

    x, y = synth(RESUME_ROWS, D, 0)
    wf, ref_sel = _resume_workflow(x, y)
    _sync(torch, dev)
    t0 = time.perf_counter()
    ref = wf.train(device=dev)
    _sync(torch, dev)
    ref_s = time.perf_counter() - t0
    ref_sum = ref.fitted[ref_sel.uid].summary
    resume = os.path.join(tmp, "resume")
    wf, sel = _resume_workflow(x, y)
    killed = False
    harness = FaultHarness().script("device_sync", [None, None, RuntimeError("killed")])
    with harness:
        try:
            wf.train(device=dev, resume=resume)
        except RuntimeError as e:
            killed = "killed" in str(e)
    check(killed, "the first run died at the third family's device sync")
    journal_path = os.path.join(resume, "sweep_journal.json")
    check(len(SweepJournal(journal_path).keys()) == 2, "two blocks committed before the kill")
    launched = []
    real = MB.PredictionEstimatorBase.cv_sweep_async

    def counted(self, *a, **k):
        launched.append(type(self).__name__)
        return real(self, *a, **k)

    MB.PredictionEstimatorBase.cv_sweep_async = counted
    wf, sel = _resume_workflow(x, y)
    _reset_all(KE)
    try:
        _sync(torch, dev)
        t0 = time.perf_counter()
        model = wf.train(device=dev, resume=resume)
        _sync(torch, dev)
        resumed_s = time.perf_counter() - t0
    finally:
        MB.PredictionEstimatorBase.cv_sweep_async = real
    launches = _all_counts(KE)
    res = resilience.last()
    summ = model.fitted[sel.uid].summary
    win = model.fitted[sel.uid].model
    refit_levels = win.max_depth * (win.n_trees if "GBT" in type(win).__name__ else 1) \
        if hasattr(win, "trees") else 0
    gbt_levels = 50 * 3
    check(res.journal.hits == 2 and res.journal.commits == 2,
          f"journal hits {res.journal.hits}, commits {res.journal.commits}")
    check(launched == ["GradientBoostedTreesClassifier", "LinearSVC"],
          f"only the uncommitted families launched: {launched}")
    for k in ("hist_level", "split_scan", "row_select_lanes"):
        check(dev.type != "cuda" or launches[k] == gbt_levels + refit_levels,
              f"{k}: {launches[k]} launches == the GBT's {gbt_levels} + refit "
              f"{refit_levels} (the replayed forest launched nothing)")
    check(summ.best_model_name == ref_sum.best_model_name
          and summ.best_grid == ref_sum.best_grid
          and [e.metric_values for e in summ.validation_results]
          == [e.metric_values for e in ref_sum.validation_results]
          and _winner_arrays(model, sel) == _winner_arrays(ref, ref_sel),
          "the resumed model bitwise the uninterrupted run's")
    # an out-of-memory at the GBT's launch: the bucket ladder
    oom_dir = os.path.join(tmp, "resume_oom")
    harness = FaultHarness().fail_when(
        "sweep_dispatch",
        lambda ctx: ctx["family"] == "GradientBoostedTreesClassifier"
        and ctx["rows"] > RESUME_ROWS // 2,
        lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    wf, sel = _resume_workflow(x, y)
    with harness:
        oom_model = wf.train(device=dev, resume=oom_dir)
    ores = resilience.last()
    keys = SweepJournal(os.path.join(oom_dir, "sweep_journal.json")).keys()
    check(ores.degradations == [{"kind": "bucket_shrink",
                                 "family": "GradientBoostedTreesClassifier",
                                 "rows_from": RESUME_ROWS, "row_cap": RESUME_ROWS // 2}],
          f"the GBT degraded to the next bucket: {ores.degradations}")
    check(len(keys) == 3, f"nothing committed for the degraded block: {len(keys)} keys")
    check("TM822" in [d.code for d in ores.diagnostics], "TM822 recorded")
    gbt = [e for e in oom_model.fitted[sel.uid].summary.validation_results
           if e.model_name == "GradientBoostedTreesClassifier"]
    check(gbt and all(np.isfinite(v) for e in gbt for v in e.metric_values),
          "the degraded GBT's CV metrics are finite")
    return {"rows": RESUME_ROWS, "uninterrupted_s": ref_s, "resumed_s": resumed_s,
            "journal_hits": res.journal.hits, "launched_families": launched,
            "launches": launches, "winner": summ.best_model_name,
            "bitwise_equal": True,
            "oom": {"degradations": ores.degradations, "journal_keys": len(keys)}}


def phase_streaming(torch, KE, dev) -> dict:
    """Phase 21: (a) parity, (b) full width timed, (c) the continual loop,
    (d) resume."""
    import shutil
    import tempfile

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    tmp = tempfile.mkdtemp(prefix="tmog_stream_")
    try:
        out = {"parity": _stream_parity(torch, KE, dev, schema, tmp)}
        emit({"phase": "streaming_parity", **out["parity"]})
        out["timed"] = _stream_timed(torch, KE, dev, schema, tmp)
        emit({"phase": "streaming_timed", **out["timed"]})
        out["continual"] = _continual(torch, KE, dev, tmp)
        emit({"phase": "streaming_continual", **out["continual"]})
        out["resume"] = _resume(torch, KE, dev, tmp)
        emit({"phase": "streaming_resume", **out["resume"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: phase 22: the fleet's tenants (name, fixture, precision, SLO class), the
#: reduced-precision registrations the TM511 gate refuses on the phase's
#: calibration batch (in both packages: one of 1024 real records puts a value
#: within a bf16 / int8 step of a tree bucketizer's split, and the flipped
#: bucket moves the raw margin by ~1), the records each tenant is sent, and
#: the candidate the admission check registers (the wide pipeline's
#: workflow-CV fixture: serving_wide's shapes, its own fitted state)
FLEET_TENANTS = (("wide_f32", FIXTURE, "f32", "gold"),
                 ("wide_f32_twin", FIXTURE, "f32", "gold"),
                 ("families", FAMILIES_FIXTURE, "f32", "bronze"),
                 ("families_bf16", FAMILIES_FIXTURE, "bf16", "silver"),
                 ("families_int8", FAMILIES_FIXTURE, "int8", "bronze"))
FLEET_REFUSED = (("wide_bf16", "bf16", "silver"), ("wide_int8", "int8", "bronze"))
FLEET_CANDIDATE = WCV_FIXTURE
FLEET_WIDE_RECORDS = 2048
FLEET_FAMILY_RECORDS = 1024
FLEET_CALIBRATION = 1024
FLEET_CLIENTS = 8
FLEET_WINDOW = 128
BF16_ULP = 2.0 ** -8


def _settled(torch) -> int:
    """Device bytes allocated once every freed tensor is gone."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _reduced_vectors(card, cpu, batch, precision: str) -> float:
    """The card plan's prefix vectors against the CPU plan's of its class:
    int8 bitwise; bf16's largest relative error (at most one bf16 ulp)."""
    import numpy as np

    entries = cpu._encode_records(batch)[1]
    worst = 0.0
    for g, c in zip(card._fused(*entries), cpu._fused(*entries)):
        if precision == "int8":
            check(g.tobytes() == c.tobytes(),
                  "int8 prefix vectors bitwise the CPU int8 plan's")
            continue
        fin = ~np.isnan(c)
        rel = np.abs(g[fin] - c[fin]) / np.maximum(np.abs(c[fin]), 1e-30)
        worst = max(worst, float(np.max(rel, initial=0.0)))
    check(worst <= BF16_ULP, f"bf16 prefix vectors within 1 bf16 ulp of the CPU "
                             f"bf16 plan's ({worst})")
    return worst


def _estimate_against_card(torch, name, model, precision, records) -> dict:
    """One fingerprint alone on the card: the rise of max_memory_allocated
    over warm() and one max_bucket batch, beside the static estimate; a
    reduced class's prefix vectors against the CPU plan's."""
    from transmogrifai_tpu_torch.checkers.plancheck import analyze_scoring_plan
    from transmogrifai_tpu_torch.serve import compile_plan

    plan = compile_plan(model, 8, BATCH, precision=precision)
    est = analyze_scoring_plan(plan).peak_hbm_bytes
    base = _settled(torch)
    torch.cuda.reset_peak_memory_stats()
    plan.warm()
    plan.score(records[:BATCH])
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    held = _settled(torch) - base
    out = {"estimate_bytes": est, "card_peak_rise_bytes": rise, "ratio": est / rise,
           "resident_after_warm_bytes": held}
    if precision != "f32":
        cpu = compile_plan(model, 8, BATCH, precision=precision, device="cpu")
        out["prefix_max_rel_err"] = _reduced_vectors(plan, cpu, records[:BATCH], precision)
    plan.release_executables()
    del plan
    out["left_after_release_bytes"] = _settled(torch) - base
    check(rise <= est <= 4 * rise,
          f"{name}: static estimate {est} B within 1x-4x of the card's peak rise {rise} B")
    return out


def phase_fleet(torch, KE, dev) -> dict:
    """Phase 22: tenants' models of every precision class behind one
    FleetServer on the card."""
    import threading
    from collections import deque

    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
    from transmogrifai_tpu_torch.serve import (TM511_BOUNDS, FaultHarness, FleetServer,
                                               ModelRegistry, compile_plan)

    t_start = time.perf_counter()
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    with open(os.path.join(FAMILIES_FIXTURE, "records.json")) as fh:
        fam_recorded = json.load(fh)
    fam = [r for b in fam_recorded["batches"] for r in b["records"]]
    recs = {"wide": make_records(schema, FLEET_WIDE_RECORDS, np.random.default_rng(22)),
            # copies: a record is held to the CPU plan's by its identity
            "families": [dict(fam[i % len(fam)]) for i in range(FLEET_FAMILY_RECORDS)]}
    fixture = {t: fx for t, fx, _, _ in FLEET_TENANTS}
    source = {t: ("families" if fx == FAMILIES_FIXTURE else "wide") for t, fx in fixture.items()}
    precision = {t: p for t, _, p, _ in FLEET_TENANTS}
    slo = {t: c for t, _, _, c in FLEET_TENANTS}
    models = {t: WorkflowModel.load(fx) for t, fx in fixture.items()}
    out = {"tenants": {t: {"fixture": fixture[t], "precision": precision[t], "slo": slo[t]}
                       for t in fixture}}

    # (a) each fingerprint's static estimate against the card, alone (and
    # the wide model's reduced classes at full width against the CPU)
    est = {}
    for t, fx, p in (("wide_f32", FIXTURE, "f32"), ("wide_bf16", FIXTURE, "bf16"),
                     ("wide_int8", FIXTURE, "int8"), ("families", FAMILIES_FIXTURE, "f32"),
                     ("families_bf16", FAMILIES_FIXTURE, "bf16"),
                     ("families_int8", FAMILIES_FIXTURE, "int8")):
        est[t] = _estimate_against_card(torch, t, WorkflowModel.load(fx), p,
                                        recs["families" if fx == FAMILIES_FIXTURE else "wide"])
    out["estimate"] = est
    seconds = {"estimate": time.perf_counter() - t_start}

    fleet = FleetServer(max_batch=BATCH, max_wait_ms=2)
    try:
        # (b) registration: the twin shares the wide f32 tenant's device
        # state; the gate refuses the wide model's reduced classes, leaving
        # nothing behind; the families model's pass it
        fleet.register("wide_f32", models["wide_f32"], slo="gold")
        before = _settled(torch)
        fleet.register("wide_f32_twin", models["wide_f32_twin"], slo="gold")
        twin_bytes = _settled(torch) - before
        m = fleet.metrics()
        check(twin_bytes == 0 and m["fleet"]["shared_prefix_registrations"] == 1
              and m["tenants"]["wide_f32_twin"]["plan"]["staging_builds"] == 0,
              f"the shared-fingerprint twin allocated {twin_bytes} B on the card and "
              "built no staging")
        refused = {}
        for t, p, c in FLEET_REFUSED:
            before = _settled(torch)
            try:
                fleet.register(t, WorkflowModel.load(FIXTURE), slo=c, precision=p,
                               calibration=recs["wide"][:FLEET_CALIBRATION])
                check(False, f"{t} passed the TM511 gate")
            except OpCheckError as e:
                codes = [d.code for d in e.report.errors()]
                check(codes == ["TM511"], f"{t} refused with TM511: {codes}")
                refused[t] = {"code": "TM511", "message": e.report.errors()[0].message}
            check(t not in fleet.tenants() and _settled(torch) == before,
                  f"the {t} refusal registered nothing and left nothing on the card")
        for t in ("families", "families_bf16", "families_int8"):
            fleet.register(t, models[t], slo=slo[t], precision=precision[t],
                           calibration=recs["families"][:FLEET_CALIBRATION]
                           if precision[t] != "f32" else None)
        plans = {t: fleet.models.get(t).swapper.active.plan for t in fixture}
        check(all(p.device.type == "cuda" and p.warm_buckets() == p.bucket_ladder()
                  for p in plans.values()), "every tenant warm on the card")
        out["sharing"] = {"twin_device_bytes": twin_bytes,
                          "shared_prefix_registrations":
                          m["fleet"]["shared_prefix_registrations"]}
        out["tm511_refused"] = refused
        seconds["register"] = time.perf_counter() - t_start - sum(seconds.values())

        # (c) load: 8 closed-loop clients (FLEET_WINDOW outstanding each)
        # mixing the tenants' requests
        begun = {t: [] for t in plans}
        captured = {t: _capture_batches(p, begun[t]) for t, p in plans.items()}
        counts0 = {t: p.metrics()["compile_count"] for t, p in plans.items()}
        work = [(t, r) for t in plans for r in recs[source[t]]]
        work = [work[i] for i in np.random.default_rng(7).permutation(len(work))]
        shares = [work[k::FLEET_CLIENTS] for k in range(FLEET_CLIENTS)]
        results = [[] for _ in range(FLEET_CLIENTS)]
        errors = []

        def client(k):
            try:
                window = deque()
                for t, r in shares[k]:
                    if len(window) >= FLEET_WINDOW:
                        window.popleft().result(timeout=120)
                    f = fleet.submit(t, r)
                    results[k].append((t, r, f))
                    window.append(f)
                for f in window:
                    f.result(timeout=120)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        torch.cuda.synchronize()
        KE.reset_launch_counts()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(FLEET_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t0
        launches = KE.launch_counts()
        for p in plans.values():
            del p.begin_score
        check(not errors and not any(th.is_alive() for th in threads),
              f"fleet clients finished cleanly: {errors[:3]}")
        per_tenant = fleet.batcher.tenant_metrics()
        sub_batches = {t: len(c) for t, c in captured.items()}
        launched = {t: sum(n) for t, n in begun.items()}
        check(all(launched[t] == sub_batches[t] for t in plans)
              and launches["encode_slots"] == sum(launched.values()),
              f"one encode launch per tenant sub-batch: {launched} of {sub_batches} "
              f"({launches})")
        check(all(p.metrics()["compile_count"] == counts0[t] for t, p in plans.items()),
              "no staging or landing allocation after warm()")
        pairs = [p for ps in results for p in ps]
        check(len(pairs) == len(work), "every request answered")

        seconds["load"] = time.perf_counter() - t_start - sum(seconds.values())

        # (d) records against the CPU plans, sub-batch by sub-batch as served
        cpu = {t: compile_plan(models[t], 8, BATCH, precision=precision[t], device="cpu")
               for t in plans}
        pred = {t: next(f.name for f in models[t].result_features
                        if f.ftype.__name__ == "Prediction") for t in plans}
        want, reduced_dev, bf16_err = {}, {}, 0.0
        for t, batches in captured.items():
            for b in batches:
                rows = cpu[t].score(b)
                for r, row in zip(b, rows):
                    want[(t, id(r))] = row
                if precision[t] == "f32":
                    continue
                bf16_err = max(bf16_err, _reduced_vectors(plans[t], cpu[t], b, precision[t]))
                ref = cpu["families"].score(b)
                reduced_dev[t] = max([reduced_dev.get(t, 0.0)] + [
                    abs(a[pred[t]][k] - w[pred[t]][k]) for a, w in zip(rows, ref)
                    for k in w[pred[t]] if k != "prediction"])
        check(all(reduced_dev[t] <= TM511_BOUNDS[precision[t]] for t in reduced_dev),
              f"reduced tenants' scores within TM511_BOUNDS of the f32 tenant's: "
              f"{reduced_dev}")
        for t, r, f in pairs:
            check(f.result() == want[(t, id(r))],
                  f"{t}: card record == the CPU plan's for its sub-batch")
        out["load"] = {
            "clients": FLEET_CLIENTS, "window": FLEET_WINDOW, "records": len(pairs),
            "seconds": wall, "records_per_s": len(pairs) / wall,
            "sub_batches": sub_batches, "launches": launched,
            "latency_ms": {t: {q: per_tenant.get(t, {}).get(f"latency_{q}_ms")
                               for q in ("p50", "p99")} for t in plans},
            "device_ms_median": {t: statistics.median(
                x["device_ms"] for x in list(plans[t].batch_timings)[-sub_batches[t]:])
                for t in plans},
            "records_equal_cpu": True, "int8_prefix_bitwise_cpu": True,
            "bf16_prefix_max_rel_err": bf16_err,
            "reduced_score_delta_vs_f32": reduced_dev}

        seconds["checks"] = time.perf_counter() - t_start - sum(seconds.values())

        # (e) a route fault on one tenant fails only its records
        caught = {t: _capture_batches(p) for t, p in plans.items()}
        with FaultHarness().fail_when("route", lambda ctx: ctx.get("tenant") == "families",
                                      lambda: RuntimeError("injected route fault")):
            futs = [(t, r, fleet.submit(t, r)) for t in plans for r in recs[source[t]][:64]]
            got = [(t, r, f.exception(timeout=120) or f.result()) for t, r, f in futs]
        for p in plans.values():
            del p.begin_score
        check(all(isinstance(g, RuntimeError) for t, _, g in got if t == "families")
              and not caught["families"],
              "the families tenant's records failed with the route fault, its plan idle")
        served = {}
        for t, batches in caught.items():
            for b in batches:
                for r, row in zip(b, cpu[t].score(b)):
                    served[(t, id(r))] = row
        check(all(g == served[(t, id(r))] for t, r, g in got if t != "families"),
              "every other tenant's records == the CPU plan's, as without the fault")
        out["faults"] = {"route_failed": sum(1 for t, _, _ in got if t == "families"),
                         "others_served": sum(1 for t, _, _ in got if t != "families")}

        # (f) admission: a budget with room for one more tenant only once the
        # least recently scored goes; then a candidate over a budget: TM509
        victim = "families_int8"
        for t in (victim, "families_bf16", "families", "wide_f32_twin", "wide_f32"):
            fleet.score(t, recs[source[t]][0], timeout=60)   # the LRU order
        candidate = WorkflowModel.load(FLEET_CANDIDATE)
        need = fleet.models._peak_bytes(compile_plan(candidate, 8, BATCH))
        resident = fleet.models.resident_hbm_bytes()
        fleet.models.hbm_budget = resident - fleet.models._peak_bytes(plans[victim]) + need
        evictions0 = fleet.metrics()["fleet"]["evictions"]
        before = _settled(torch)
        fleet.register("wide_wcv", candidate, slo="silver", warm=False)
        freed = before - _settled(torch)
        released = plans[victim].last_released_bytes
        m = fleet.metrics()
        check(m["fleet"]["evictions"] == evictions0 + 1
              and m["tenants"][victim]["warm_buckets"] == []
              and all(m["tenants"][t]["warm_buckets"] for t in plans if t != victim),
              f"the least recently scored tenant ({victim}) evicted, the others warm")
        check(released > 0 and abs(freed - released) <= 512,
              f"memory_allocated fell by the evicted tenant's released bytes "
              f"({freed} vs {released})")
        row = fleet.score(victim, recs["families"][0], timeout=60)
        check(row == cpu[victim].score([recs["families"][0]])[0],
              "the evicted tenant still serves")
        small = ModelRegistry(hbm_budget=need - 1)
        before = _settled(torch)
        try:
            small.register("too_big", WorkflowModel.load(FLEET_CANDIDATE))
            check(False, "a candidate larger than the budget was admitted")
        except OpCheckError as e:
            check([d.code for d in e.report.errors()] == ["TM509"], f"TM509: {e}")
        check(len(small) == 0 and _settled(torch) == before
              and small.metrics()["fleet"]["admission_refusals"] == 1,
              "the refusal changed nothing")
        out["admission"] = {"budget": fleet.models.hbm_budget, "candidate_bytes": need,
                            "evicted": victim, "freed_bytes": freed,
                            "released_bytes": released, "refused": "TM509"}
        out["statusz"] = {t: {k: v for k, v in r.items()
                              if k in ("precision", "completed", "p99_ms", "warm_buckets")}
                          for t, r in fleet.statusz()["tenants"].items()}
    finally:
        fleet.close()
    seconds["faults_admission"] = time.perf_counter() - t_start - sum(seconds.values())
    out["seconds"] = time.perf_counter() - t_start
    out["seconds_by_part"] = seconds
    emit({"phase": "fleet", **out})
    return out


#: phase 23: the telemetry layer on the card.  (a) the wide server's load
#: under telemetry off, at the batch and at the requests detail; (b) two
#: tenants' device cost; (c) a TMOG_PROFILE capture; (d) a traced train of
#: phase 10's table with a tree family and a warm refit; (e) the runner with
#: collect_stage_metrics.  Sizes cut to keep the phase near 25 s.
OBS_RECORDS = 4096
OBS_REPS = 3
OBS_FIXED_RECORDS = 2048
OBS_CLIENTS = 8
OBS_WINDOW = 256
OBS_FLEET_WIDE = 1024
OBS_FLEET_FAMILIES = 128
OBS_TRAIN_ROWS = 1 << 16
OBS_REFIT_ROWS = 1 << 13
OBS_RUNNER_ROWS = 1 << 13
OBS_GBT_GRID = {"num_rounds": 10, "max_depth": 3}
#: (d)'s trains, in order: the first train of the table is also its
#: warm-up (the caching allocator's blocks of its size), so the untraced
#: one runs first and the traced one is held to it
OBS_TRAIN_ORDER = ("plain", "traced")


def _nesting_violations(events) -> list:
    """X events of one tid must nest: two spans are disjoint or one holds
    the other (1 us of clock rounding allowed)."""
    by_tid = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_tid.setdefault(ev["tid"], []).append(ev)
    bad = []
    for tid, evs in by_tid.items():
        stack = []
        for ev in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1.0:
                stack.pop()
            if stack and ev["ts"] + ev["dur"] > stack[-1]["ts"] + stack[-1]["dur"] + 1.0:
                bad.append((stack[-1]["name"], ev["name"]))
            stack.append(ev)
    return bad


def _obs_server_run(torch, KE, server, batches, records, cpu_plan,
                    detail: Optional[str], check_records: bool) -> dict:
    """One closed-loop run (OBS_CLIENTS threads) of the warm wide server
    under ``Telemetry(detail=...)``, or with telemetry off (None): 0 compile
    events, one encode launch per flushed batch, statusz's device seconds
    the plan's sums; with ``check_records`` every served record equals the
    CPU plan's record for its batch."""
    from transmogrifai_tpu_torch.obs import Telemetry
    from transmogrifai_tpu_torch.perf import measure_compiles

    tel = Telemetry(detail=detail) if detail is not None else None
    batches.clear()
    torch.cuda.synchronize()
    KE.reset_launch_counts()
    bat0 = server.batcher.metrics()
    if tel is not None:
        tel.start()
    try:
        with measure_compiles() as probe:
            pairs, wall = _drive_clients(server, records, OBS_CLIENTS, OBS_WINDOW)
    finally:
        if tel is not None:
            tel.stop()
    launches = KE.launch_counts()["encode_slots"]
    bat = server.batcher.metrics()
    status = server.statusz()
    plan_m = server.plan.metrics()
    n_batches = bat["batches"] - bat0["batches"]
    check(bat["completed"] - bat0["completed"] == len(records)
          and bat["failed"] == bat0["failed"],
          f"every request completed ({detail}): {bat['completed'] - bat0['completed']}")
    check(probe.backend_compiles == 0, f"no compile after warm() ({detail}): "
          f"{probe.to_dict()}")
    check(launches == n_batches == len(batches),
          f"one encode launch per flushed batch ({detail}): {launches} / {n_batches}")
    if check_records:
        want = _expected(cpu_plan, batches)
        check(all(f.result() == want[id(r)] for r, f in pairs),
              f"every served record == the CPU plan's for its batch ({detail})")
    plan_s = plan_m["device_ms"] / 1e3
    check(status["padding_rows"] == plan_m["padding_rows"]
          and abs(status["device_seconds"] - plan_s) <= 1e-9 * max(1.0, plan_s),
          f"statusz reads the canonical counters: {status['device_seconds']} s vs the "
          f"plan's {plan_s} s")
    out = {"detail": detail or "off", "records": len(records),
           "records_per_s": len(records) / wall, "seconds": wall,
           "batches": n_batches, "launches": launches,
           "latency_p50_ms": bat["latency_p50_ms"],
           "latency_p99_ms": bat["latency_p99_ms"],
           "records_checked": check_records}
    if tel is not None:
        evs = tel.recorder.events("backend_compile")
        check(evs == [], f"0 backend_compile events after warm() ({detail}): {evs[:3]}")
        out["trace"] = tel.tracer.chrome_trace()
        out["trace_events"] = len(tel.tracer)
    return out


def _obs_requests_checks(trace: dict) -> dict:
    from transmogrifai_tpu_torch.obs import reconstruct_request, request_events

    reqs = request_events(trace)
    flush = {ev["args"]["batch_seq"]: ev for ev in trace["traceEvents"]
             if ev.get("ph") == "X" and ev.get("name") == "serve.flush"}
    check(len(reqs) == OBS_RECORDS, f"one request track per request: {len(reqs)}")
    check(all(set(p) == {"b", "e"} and p["e"]["args"].get("batch_seq") in flush
              for p in reqs.values()),
          "every request has its begin/end pair linked to a flushed batch_seq")
    slow = max(reqs, key=lambda rid: reqs[rid]["e"]["args"]["total_ms"])
    chain = reconstruct_request(trace, slow)
    check(sorted(chain["phases"]) == ["device", "encode", "host"],
          f"the slowest request's chain has encode, device and host: {chain['phases']}")
    check(_nesting_violations(trace["traceEvents"]) == [], "X spans nest per thread")
    return {"requests": len(reqs), "slowest": chain}


def _obs_fleet(torch, KE, wide_model) -> dict:
    """(b) serving_wide and training_families behind one FleetServer: the
    per-tenant device seconds sum to the batch total, and statusz shows the
    plans' own summed device seconds."""
    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.serve import FleetServer

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    with open(os.path.join(FAMILIES_FIXTURE, "records.json")) as fh:
        fam = [r for b in json.load(fh)["batches"] for r in b["records"]]
    wide = make_records(schema, OBS_FLEET_WIDE, np.random.default_rng(23))
    fams = [dict(fam[i % len(fam)]) for i in range(OBS_FLEET_FAMILIES)]
    mixed = [("wide", r) for r in wide]
    for i, r in enumerate(fams):
        mixed.insert(4 * i + 1, ("families", r))
    t0 = time.perf_counter()
    fam_model = WorkflowModel.load(FAMILIES_FIXTURE)
    fleet = FleetServer(max_batch=BATCH, max_wait_ms=2)
    try:
        fleet.register("wide", wide_model, slo="gold")
        fleet.register("families", fam_model, slo="bronze")
        setup_s = time.perf_counter() - t0
        KE.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [fleet.submit(t, r) for t, r in mixed]
        for f in futs:
            f.result(timeout=120)
        wall = time.perf_counter() - t0
        launches = KE.launch_counts()["encode_slots"]
        total = fleet.batcher.metrics()["device_seconds"]
        per = {t: r["device_seconds"] for t, r in fleet.batcher.tenant_metrics().items()}
        status = fleet.statusz()
        plans = {t: fleet.models.get(t).swapper.active.plan.metrics()["device_ms"] / 1e3
                 for t in ("wide", "families")}
    finally:
        fleet.close()
    tenant_sum = sum(per.values())
    check(total > 0 and all(v > 0 for v in per.values()), f"device seconds billed: {per}")
    check(abs(tenant_sum - total) <= 1e-9 * total,
          f"per-tenant device seconds sum to the total: {tenant_sum} vs {total}")
    check(status["fleet"]["device_seconds"] == total
          and all(abs(status["tenants"][t]["device_seconds"] - plans[t]) <= 1e-9 * plans[t]
                  for t in plans),
          f"statusz shows the plans' device seconds: {status['fleet']['device_seconds']} "
          f"vs {plans}")
    return {"records": len(mixed), "records_per_s": len(mixed) / wall,
            "device_seconds": total, "tenant_device_seconds": per,
            "plan_device_seconds": plans, "sum_minus_total": tenant_sum - total,
            "launches": launches, "setup_s": setup_s, "serve_s": wall}


#: (c)'s fresh process: the fixture's plan on the card, one batch scored
#: plain, then again under TMOG_PROFILE
_PROFILE_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from transmogrifai_tpu_torch import WorkflowModel
args = json.load(open(sys.argv[1]))
plan = WorkflowModel.load(args["fixture"]).serving_plan().warm()
plain = plan.score(args["records"])
os.environ["TMOG_PROFILE"] = args["dir"]
profiled = plan.score(args["records"])
with open(args["out"], "w") as fh:
    json.dump({"equal": profiled == plain}, fh)
"""


def _capture_kernels(d: str) -> list:
    """The kernel names of the one Chrome trace TMOG_PROFILE wrote to ``d``."""
    files = os.listdir(d)
    check(len(files) == 1, f"one capture per dispatch: {files}")
    with open(os.path.join(d, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted({e.get("name", "") for e in events if e.get("cat") == "kernel"})


def _obs_profile(torch, KE, model, records) -> dict:
    """(c) TMOG_PROFILE around one served batch.  In a fresh process (as a
    user sets it for a run) the capture names the encode kernel and the
    records equal an unprofiled batch's.  In this process, after the
    earlier phases, the records must equal too, and the capture either
    names the kernel or says it is short of kernels (``last_capture``:
    torch's profiler drops a capture's first GPU events in a process that
    has lived minutes; PERF.md, open questions)."""
    import shutil
    import subprocess
    import tempfile

    from transmogrifai_tpu_torch.obs.profile import last_capture

    tmp = tempfile.mkdtemp(prefix="tmog_prof_")
    try:
        child = {"fixture": FIXTURE, "records": records,
                 "dir": os.path.join(tmp, "child"), "out": os.path.join(tmp, "child.json")}
        with open(os.path.join(tmp, "args.json"), "w") as fh:
            json.dump(child, fh)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _PROFILE_CHILD,
                               os.path.join(tmp, "args.json")],
                              capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the profiled child process ran: {proc.stderr[-2000:]}")
        with open(child["out"]) as fh:
            check(json.load(fh)["equal"], "profiled records == unprofiled records (child)")
        kernels = _capture_kernels(child["dir"])
        check(any("encode_slots_kernel" in k for k in kernels),
              f"the capture names encode_slots_kernel: {kernels[:20]}")
        size = sum(os.path.getsize(os.path.join(child["dir"], f))
                   for f in os.listdir(child["dir"]))
        # the same in this process
        plan = model.serving_plan().warm()
        plain = plan.score(records)
        os.environ["TMOG_PROFILE"] = os.path.join(tmp, "here")
        try:
            KE.reset_launch_counts()
            t0 = time.perf_counter()
            profiled = plan.score(records)
            seconds = time.perf_counter() - t0
            launches = KE.launch_counts()["encode_slots"]
        finally:
            del os.environ["TMOG_PROFILE"]
        check(profiled == plain and launches == 1,
              "profiled records == unprofiled records, one encode launch (this process)")
        here = _capture_kernels(os.path.join(tmp, "here"))
        cap = last_capture()
        names = any("encode_slots_kernel" in k for k in here)
        check(cap.get("launches", 0) >= 1 and (names or not cap["complete"]),
              f"the in-process capture names encode_slots_kernel or says it is "
              f"short of kernels: {cap}, kernels {here[:20]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"capture_bytes": size, "kernels": kernels, "child_s": child_s,
            "seconds": seconds, "launches": launches,
            "in_process_kernels": len(here),
            "in_process_names_encode": names,
            "in_process_launches": cap["launches"], "in_process_device_kernels": cap["kernels"],
            "in_process_complete": cap["complete"],
            "records_equal_unprofiled": True}


def _obs_train(torch, KE, dev) -> dict:
    """(d) phase 10's table at OBS_TRAIN_ROWS under a 2-fold LR + GBT
    selector: untraced, then Workflow.train(telemetry=dir); the warm refit
    under a flight recorder; a cold bucket in a warm context."""
    import tempfile

    import transmogrifai_tpu_torch as T
    from torch_wide_data import FIXTURE_SHAPE, make_data, wide_pipeline
    from transmogrifai_tpu_torch.models.trees import GradientBoostedTreesClassifier
    from transmogrifai_tpu_torch.obs import FlightRecorder, Telemetry, flight
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow import continual as C

    t0 = time.perf_counter()
    cols, schema = make_data(OBS_TRAIN_ROWS, seed=41, **FIXTURE_SHAPE)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    del cols
    data_s = time.perf_counter() - t0
    models = [(T.LogisticRegression(), [{"reg_param": 0.01}]),
              (GradientBoostedTreesClassifier(), [dict(OBS_GBT_GRID)])]

    def train(telemetry=None):
        label, sel, chk, pred = wide_pipeline(T, ftypes, schema, models=models)
        wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
        _sync(torch, dev)
        t = time.perf_counter()
        model = wf.train(device=dev, telemetry=telemetry)
        _sync(torch, dev)
        return model, time.perf_counter() - t

    times = {"plain": [], "traced": []}
    for kind in OBS_TRAIN_ORDER:
        if kind == "plain":
            times["plain"].append(train()[1])
            continue
        d = tempfile.mkdtemp(prefix="tmog_obs_train_")
        _reset_all(KE)
        model, traced_s = train(telemetry=d)
        launches = _all_counts(KE)
        times["traced"].append(traced_s)
    plain_s = times["plain"][-1]
    check(all(launches[k] > 0 for k in ("hist_level", "split_scan", "row_select_lanes",
                                        "encode_slots")),
          f"K1-K3 and the encode kernel launched in the traced train: {launches}")
    check(sorted(os.listdir(d)) == ["flight.json", "metrics.jsonl", "trace.json"],
          f"train(telemetry=) dumped the reference's files: {os.listdir(d)}")
    with open(os.path.join(d, "trace.json")) as fh:
        trace = json.load(fh)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    fam = "GradientBoostedTreesClassifier"
    want = {"fit.modelSelector", "fit.modelSelector.prep", "fit.modelSelector.validate",
            f"fit.modelSelector.validate.cv.dispatch.{fam}",
            f"fit.modelSelector.validate.cv.gather.{fam}",
            "fit.modelSelector.refit", "fit.modelSelector.train_eval",
            "fit.sanityChecker", "transform.fused_plan"}
    check(want <= names and all(e["cat"] == "train" for e in spans),
          f"train.* spans of the reference's names: missing {sorted(want - names)}")
    check(_nesting_violations(spans) == [], "train spans nest as the reference's")
    sel_span = next(e for e in spans if e["name"] == "fit.modelSelector")
    inner = [e for e in spans if e["name"].startswith("fit.modelSelector.")]
    check(all(sel_span["ts"] - 1.0 <= e["ts"] and e["ts"] + e["dur"]
              <= sel_span["ts"] + sel_span["dur"] + 1.0 for e in inner),
          "the selector's phases lie inside fit.modelSelector")
    with open(os.path.join(d, "metrics.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh.read().splitlines()]
    check(len(lines) == 1 and lines[0]["source"] == "Workflow.train"
          and lines[0]["compile"]["events"].get("nvcc_build", 0) == 0,
          f"one compile line, 0 nvcc builds: {lines[-1]['compile']}")
    with open(os.path.join(d, "flight.json")) as fh:
        train_flight = json.load(fh)
    # the training path allocates no serving bucket; the trained model's
    # plan warming under a recorder does, one staging + landing per bucket
    with Telemetry(out_dir=d) as tel:
        plan = model.serving_plan().warm()
    with open(os.path.join(d, "flight.json")) as fh:
        warm_flight = [e for e in json.load(fh)["events"] if e["kind"] == "backend_compile"]
    check(len(warm_flight) == 2 * len(plan.bucket_ladder())
          and {e["data"]["what"] for e in warm_flight} == {"staging", "landing"}
          and not any(e["data"]["unexpected"] for e in warm_flight),
          f"flight.json holds the plan's bucket allocations: {len(warm_flight)}")
    del tel
    # the warm refit inside compile_context(warm=True): 0 events, no TM901
    import numpy as np

    window = ds.take(np.arange(OBS_REFIT_ROWS))
    refit = C.RefitController(model, sleep=lambda s: None)
    refit.prime(window)
    rec = flight.install_recorder(FlightRecorder())
    try:
        t = time.perf_counter()
        res = refit.refit(window)
        refit_s = time.perf_counter() - t
        refit_events = rec.events("backend_compile")
        check(res.backend_compiles == 0 and refit_events == []
              and rec.diagnostics() == [],
              f"the warm refit recorded 0 compile events and no TM901: {refit_events[:3]}")
        # a deliberately cold bucket inside a warm context
        cold = model.serving_plan(min_bucket=2, max_bucket=2)
        cold.release_executables()
        with open(os.path.join(FIXTURE, "schema.json")) as fh:
            fixture_schema = json.load(fh)
        cold_recs = [{k: v for k, v in r.items() if k != "label"}
                     for r in make_records(fixture_schema, 2, np.random.default_rng(2))]
        with flight.compile_context("chip_smoke.cold", warm=True):
            cold.score(cold_recs)
        diags = rec.diagnostics()
        check(rec.unexpected_compiles >= 1 and {x.code for x in diags} == {"TM901"},
              f"a cold bucket in a warm context raised TM901: {diags}")
    finally:
        flight.uninstall_recorder()
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    return {"rows": OBS_TRAIN_ROWS, "data_s": data_s, "order": list(OBS_TRAIN_ORDER),
            "train_s": times, "traced_over_plain": traced_s / plain_s,
            "train_spans": len(spans), "train_flight_compile_events":
            sum(1 for e in train_flight["events"] if e["kind"] == "backend_compile"),
            "compile_line": lines[0]["compile"], "warm_flight_compile_events": len(warm_flight),
            "refit_rows": OBS_REFIT_ROWS, "refit_s": refit_s,
            "refit_backend_compiles": res.backend_compiles,
            "tm901_cold_bucket": rec.unexpected_compiles, "launches": launches}


def _obs_runner(torch, KE, dev) -> dict:
    """(e) WorkflowRunner TRAIN with collect_stage_metrics: a fit and a
    transform record per stage; an extra listener reads the card's memory."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import FIXTURE_SHAPE, make_data, wide_pipeline
    from transmogrifai_tpu_torch.params import OpParams
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.utils.listener import (OpMetricsListener, add_listener,
                                                        remove_listener)
    from transmogrifai_tpu_torch.workflow.runner import RunType, WorkflowRunner

    cols, schema = make_data(OBS_RUNNER_ROWS, seed=43, **FIXTURE_SHAPE)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = T.Dataset.from_features(cols, ftypes)
    del cols
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    mem = add_listener(OpMetricsListener(track_device_memory=True))
    try:
        t = time.perf_counter()
        res = WorkflowRunner(workflow=wf).run(RunType.TRAIN,
                                              OpParams(collect_stage_metrics=True))
        seconds = time.perf_counter() - t
    finally:
        remove_listener(mem)
    app = res.metrics["appMetrics"]
    recs = app["stageMetrics"]
    stages = {m["stage_uid"] for m in recs}
    by = {(m["stage_uid"], m["phase"]) for m in recs}
    estimators = {m["stage_uid"] for m in recs if m["phase"] == "fit"}
    check(app["runType"] == "train" and all((u, "transform") in by for u in stages)
          and all((u, "fit") in by for u in estimators) and len(estimators) >= 3,
          f"a fit record per estimator and a transform record per stage: "
          f"{len(estimators)} fits, {len(stages)} stages")
    check(all(m["n_rows"] == OBS_RUNNER_ROWS for m in recs), "every record has the rows")
    in_use = [m.device_bytes_in_use for m in mem.metrics.stage_metrics]
    peak = [m.device_peak_bytes for m in mem.metrics.stage_metrics]
    check(all(v is not None and v > 0 for v in in_use + peak),
          "torch.cuda reports the card's memory for every stage")
    return {"rows": OBS_RUNNER_ROWS, "seconds": seconds, "records": len(recs),
            "fits": len(estimators), "stages": len(stages),
            "device_bytes_in_use_max": max(in_use), "device_peak_bytes_max": max(peak)}


def phase_obs(torch, KE, dev) -> dict:
    """Phase 23: the telemetry layer on the card's paths."""
    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.obs import Telemetry
    from transmogrifai_tpu_torch.serve import ScoringServer

    t_start = time.perf_counter()
    left0 = KE.left_closed_launches
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    model = WorkflowModel.load(FIXTURE)
    cpu_plan = model.serving_plan(device="cpu")
    records = make_records(schema, OBS_RECORDS, np.random.default_rng(24))
    seconds = {}
    # (a) telemetry off, at the batch detail, at the requests detail, in
    # turn, OBS_REPS times over one warm server
    runs = []
    with ScoringServer(model, max_batch=BATCH, max_wait_ms=2) as server:
        batches = _capture_batches(server.plan)
        for rep in range(OBS_REPS):
            for detail in (None, "batch", "requests"):
                runs.append(_obs_server_run(torch, KE, server, batches, records,
                                            cpu_plan, detail, check_records=rep == 0))
        status = server.statusz()
        plan_m = server.plan.metrics()
    req = _obs_requests_checks(next(r for r in runs if r["detail"] == "requests")["trace"])
    for r in runs:
        r.pop("trace", None)
    rps = {d: [r["records_per_s"] for r in runs if r["detail"] == d]
           for d in ("off", "batch", "requests")}
    # flush on size: the same batches on and off, records bitwise equal
    fixed = {}
    for detail in (None, "requests"):
        with ScoringServer(model, max_batch=BATCH, max_wait_ms=SIZE_ONLY_MS,
                           pipeline_depth=0) as srv:
            tel = Telemetry(detail=detail) if detail else None
            if tel is not None:
                tel.start()
            try:
                fixed[detail] = [f.result(timeout=120) for f in
                                 [srv.submit(r) for r in records[:OBS_FIXED_RECORDS]]]
            finally:
                if tel is not None:
                    tel.stop()
    check(fixed[None] == fixed["requests"],
          "records bitwise equal with telemetry on and off (the same batches)")
    seconds["server"] = time.perf_counter() - t_start
    seconds["server_loads"] = sum(r["seconds"] for r in runs)
    fleet = _obs_fleet(torch, KE, model)
    seconds["fleet"] = time.perf_counter() - t_start - seconds["server"]
    t_part = time.perf_counter()
    prof = _obs_profile(torch, KE, model, records[:BATCH])
    seconds["profile"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    train = _obs_train(torch, KE, dev)
    seconds["train"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    runner = _obs_runner(torch, KE, dev)
    seconds["runner"] = time.perf_counter() - t_part
    off = statistics.median(rps["off"])
    out = {"server": {"runs": runs, "requests_detail": req,
                      "records_per_s_median": {d: statistics.median(v)
                                               for d, v in rps.items()},
                      "batch_over_off": statistics.median(rps["batch"]) / off,
                      "requests_over_off": statistics.median(rps["requests"]) / off,
                      "device_seconds": status["device_seconds"],
                      "plan_device_s": plan_m["device_ms"] / 1e3,
                      "plan_dispatch_s": plan_m["dispatch_ms"] / 1e3,
                      "padding_rows": status["padding_rows"],
                      "records_equal_on_off": OBS_FIXED_RECORDS},
           "fleet": fleet, "profile": prof, "train": train, "runner": runner,
           "launches": {"encode_slots": sum(r["launches"] for r in runs)
                        + fleet["launches"] + prof["launches"]
                        + train["launches"]["encode_slots"],
                        "left_closed": KE.left_closed_launches - left0,
                        **{k: train["launches"][k]
                           for k in ("hist_level", "split_scan", "row_select_lanes")}},
           "seconds_by_part": seconds, "seconds": time.perf_counter() - t_start}
    emit({"phase": "obs", **out})
    return out

# -- the out-of-core path: chunked store, chunked epochs, score_dataset -----

OOC_ROWS = 1 << 16          # 8 chunks of the reference's 8192 rows
OOC_RESUME_ROWS = 1 << 15   # 4 chunks
OOC_CHUNK = 8192
OOC_GBT_GRID = {"num_rounds": 5, "max_depth": 3}
OOC_SAMPLE = 2048           # rows held equal to Dataset.from_features


def _ooc_dataset(T, cols: dict, ftypes: dict):
    """``Dataset.from_features`` of make_data's columns built with numpy
    (the per-value conversion takes ~10x longer at OOC_ROWS); the phase
    holds its first OOC_SAMPLE rows equal to from_features'."""
    import numpy as np

    from transmogrifai_tpu_torch.types import ColumnKind

    out = {}
    for name, vals in cols.items():
        ft = ftypes[name]
        if ft.kind in (ColumnKind.FLOAT, ColumnKind.BOOL):
            mask = np.fromiter((v is not None for v in vals), np.bool_, len(vals))
            dtype = np.float64 if ft.kind is ColumnKind.FLOAT else np.bool_
            data = np.array([0 if v is None else v for v in vals], dtype=dtype)
            out[name] = T.Column(ft, data, mask)
        else:
            data = np.empty(len(vals), dtype=object)
            data[:] = vals
            out[name] = T.Column(ft, data)
    return T.Dataset(out)


def _ooc_states(model) -> dict:
    """The fitted fills, vocabularies, splits and kept indices, in input
    order (the checker's inputs are named by stage uids)."""
    import numpy as np

    out = {}
    for cls, attr in (("NumericVectorizerModel", "fills"),
                      ("OneHotVectorizerModel", "vocabs"),
                      ("DecisionTreeNumericBucketizerModel", "splits"),
                      ("SanityCheckerModel", "kept_indices")):
        fitted = _fitted_by(model, cls)
        out[cls] = [np.asarray(getattr(fitted[k], attr)).tolist()
                    if attr == "fills" else getattr(fitted[k], attr)
                    for k in sorted(fitted)]
    return out


def _ooc_selection(model, sel) -> dict:
    summary = model.fitted[sel.uid].summary
    return {"winner": summary.best_model_name, "grid": summary.best_grid,
            "cv": [(e.model_name, e.grid, list(e.metric_values))
                   for e in summary.validation_results],
            "arrays": _winner_arrays(model, sel)}


def _ooc_epoch_parts(prof: list) -> dict:
    """The chunked train's seconds by part, summed over its epochs, and its
    fits' seconds by stage."""
    epochs = [r for r in prof if r["kind"] == "epoch"]
    parts: dict = {}
    for r in epochs:
        for k, v in r["parts_s"].items():
            parts[k] = parts.get(k, 0.0) + v
    fits: dict = {}
    for r in prof:
        if r["kind"] == "fit":
            fits[r["stage"]] = fits.get(r["stage"], 0.0) + r["seconds"]
    return {"epochs_s": sum(r["seconds"] for r in epochs), "epoch_parts_s": parts,
            "fits_s": fits,
            "prefetch": {k: sum(r["prefetch"].get(k, 0) for r in epochs)
                         for k in ("load_seconds", "wait_seconds", "stalls", "chunks")},
            "overlap_fraction": [r["prefetch"].get("overlap_fraction") for r in epochs],
            "bytes_spilled": sum(r["bytes_spilled"] for r in epochs),
            "epochs": [{k: r[k] for k in ("seconds", "stages", "device_stages",
                                          "encode_slots", "chunks", "encode_launches",
                                          "tile_allocations", "bytes_spilled")}
                       for r in epochs]}


def phase_ooc(torch, KE, dev) -> dict:
    """Phase 24: the wide raw-column pipeline (phase 10's table, LR 2 grids
    + GBT) out of core at OOC_ROWS.  (a) In memory, then on the chunked
    store with train(host_budget=B): equal states, bitwise CV and winner,
    one encode launch per chunk of the epoch with slots, one tile a device
    epoch.  (d) The flush's static estimate against the card's peak rise, a
    budget under it refused with TM601 before any encode launch.  (c)
    Resume at OOC_RESUME_ROWS.  (b) score_dataset over that chunked table.
    (e) The chunk-tile launch bitwise and timed."""
    import tempfile

    import numpy as np

    import transmogrifai_tpu_torch as T
    from torch_wide_data import FIXTURE_SHAPE, make_data, wide_pipeline
    from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
    from transmogrifai_tpu_torch.checkers.plancheck import analyze_transform_plan
    from transmogrifai_tpu_torch.data.chunked import ChunkedDataset, column_nbytes
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.models.trees import GradientBoostedTreesClassifier
    from transmogrifai_tpu_torch.obs import flight as obs_flight
    from transmogrifai_tpu_torch.serve.faults import FaultHarness
    from transmogrifai_tpu_torch.types import feature_type_by_name
    from transmogrifai_tpu_torch.workflow.dag import compute_dag
    from transmogrifai_tpu_torch.workflow.ooc import chunked_transform_epoch
    from transmogrifai_tpu_torch.workflow.plan import (ColumnarTransformPlan,
                                                       encode_buffer, run_host_stages)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cols, schema = make_data(OOC_ROWS, seed=0, **FIXTURE_SHAPE)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    ds = _ooc_dataset(T, cols, ftypes)
    ref = T.Dataset.from_features({k: v[:OOC_SAMPLE] for k, v in cols.items()}, ftypes)
    got = ds.take(np.arange(OOC_SAMPLE))
    for name in ref.names:
        a, b = ref[name], got[name]
        check(a.ftype is b.ftype and a.data.dtype == b.data.dtype
              and np.array_equal(a.data, b.data)
              and (a.mask is None) == (b.mask is None)
              and (a.mask is None or np.array_equal(a.mask, b.mask)),
              f"the numpy-built column {name} equals Dataset.from_features'")
    del cols, ref, got
    data_s = time.perf_counter() - t0

    def pipeline():
        models = [(LogisticRegression(), [{"reg_param": 0.01}, {"reg_param": 0.1}]),
                  (GradientBoostedTreesClassifier(), [dict(OOC_GBT_GRID)])]
        return wide_pipeline(T, ftypes, schema, models=models)

    def train(data, **kw):
        label, sel, chk, pred = pipeline()
        wf = T.Workflow().set_input_dataset(data).set_result_features(label, pred)
        _sync(torch, dev)
        _reset_all(KE)
        t = time.perf_counter()
        model = wf.train(device=dev, **kw)
        _sync(torch, dev)
        return (model, wf, {"label": label, "sel": sel, "chk": chk, "pred": pred},
                time.perf_counter() - t, _all_counts(KE))

    # (a) in memory
    model_m, wf_m, h_m, mem_s, launches_m = train(ds)
    # (d) the training flush's estimate against the card; the fit set
    vec = h_m["chk"].inputs[1]
    runners = [model_m.fitted.get(s.uid, s) for layer in compute_dag([vec])
               for s in layer]
    plan = ColumnarTransformPlan(runners, frozenset(ds.names), dev)
    est = analyze_transform_plan(plan, ds).peak_hbm_bytes
    base = _settled(torch)
    torch.cuda.reset_peak_memory_stats()
    flushed = plan.apply_prefix(ds)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    check(rise <= est <= 4 * rise,
          f"the training flush's static estimate {est} B within 1x-4x of the "
          f"card's peak rise {rise} B")
    flushed = run_host_stages(flushed, plan.remainder, device=dev)
    fit_set = column_nbytes(ds[h_m["label"].name]) + column_nbytes(flushed[vec.name])
    budget = fit_set  # the largest fit set: the checker's label and vector
    del flushed, plan

    # (a) on the chunked store
    with tempfile.TemporaryDirectory(prefix="tmog_ooc_") as tmp:
        t0 = time.perf_counter()
        cds = ChunkedDataset.from_dataset(ds, spill_dir=os.path.join(tmp, "table"))
        spill_s = time.perf_counter() - t0
        check(cds.n_chunks == OOC_ROWS // OOC_CHUNK, f"{cds.n_chunks} chunks")
        model_c, wf_c, h_c, chunked_s, launches_c = train(cds, host_budget=budget)
        check(_ooc_states(model_c) == _ooc_states(model_m),
              "fills, vocabularies, splits and kept indices equal in memory and chunked")
        sel_m, sel_c = _ooc_selection(model_m, h_m["sel"]), _ooc_selection(model_c, h_c["sel"])
        check(sel_c == sel_m, f"winner, every CV metric and the winner's arrays bitwise "
                              f"equal: {sel_c['winner']} vs {sel_m['winner']}")
        prof = wf_c.last_train_profile
        epochs = [r for r in prof if r["kind"] == "epoch"]
        with_slots = [r for r in epochs if r["encode_slots"]]
        want = sum(r["chunks"] - r["chunks_skipped"] for r in with_slots)
        check(launches_c["encode_slots"] == want == cds.n_chunks * len(with_slots)
              and len(with_slots) == 1
              and launches_c["encode_slots.slots"] == want * with_slots[0]["encode_slots"]
              and launches_c["onehot_codes"] == launches_c["bucketize_right_encode"] == 0,
              f"encode launches {launches_c['encode_slots']} == chunks x epochs with "
              f"slots ({want}): {epochs}")
        check(all(r["tile_allocations"] == (1 if r["device_stages"] else 0) for r in epochs),
              f"one tile allocation per device epoch: {epochs}")
        tree_keys = ("hist_level", "split_scan", "row_select_lanes")
        check(all(launches_c[k] == launches_m[k] > 0 for k in tree_keys),
              f"K1-K3 launch in the chunked sweep as in memory: "
              f"{ {k: (launches_c[k], launches_m[k]) for k in tree_keys} }")
        a = {"rows": OOC_ROWS, "chunks": cds.n_chunks, "host_budget": budget,
             "table_bytes": cds.nbytes, "largest_fit_set_bytes": fit_set,
             "in_memory_train_s": mem_s, "chunked_train_s": chunked_s,
             "chunked_over_in_memory": chunked_s / mem_s, "spill_table_s": spill_s,
             "launches": launches_c, "launches_in_memory": launches_m,
             "winner": sel_c["winner"], **_ooc_epoch_parts(prof)}
        emit({"phase": "ooc_train", **a})

        # (d) a budget under the estimate: TM601 before any encode launch
        label_b, _, _, pred_b = pipeline()
        wf_b = T.Workflow().set_input_dataset(ds).set_result_features(label_b, pred_b)
        _reset_all(KE)
        try:
            wf_b.train(hbm_budget=est // 2, device=dev)
            refused = None
        except OpCheckError as e:
            refused = [d.code for d in e.report]
        counts = _all_counts(KE)
        check(refused == ["TM601"] and counts["encode_slots"] == 0,
              f"hbm_budget under the estimate refused with TM601 before any encode "
              f"launch: {refused}, {counts}")
        tile_plan = ColumnarTransformPlan(
            [model_c.fitted.get(s.uid, s) for layer in compute_dag([h_c["chk"].inputs[1]])
             for s in layer], frozenset(cds.names), dev)
        tile_est = analyze_transform_plan(tile_plan, cds, OOC_CHUNK).peak_hbm_bytes
        _reset_all(KE)
        try:
            chunked_transform_epoch(cds, tile_plan._runners, hbm_budget=tile_est // 2,
                                    device=dev)
            tile_refused = None
        except OpCheckError as e:
            tile_refused = [d.code for d in e.report]
        check(tile_refused == ["TM601"] and _all_counts(KE)["encode_slots"] == 0,
              f"a chunk tile over its budget refused with TM601: {tile_refused}")
        d = {"flush_estimate_bytes": est, "flush_card_peak_rise_bytes": rise,
             "ratio": est / rise if rise else None, "refused": refused,
             "launches_when_refused": counts,
             "tile_estimate_bytes": tile_est, "tile_refused": tile_refused}
        del cds

        # (c) resume at OOC_RESUME_ROWS
        cds_r = ChunkedDataset.from_dataset(ds.take(np.arange(OOC_RESUME_ROWS)),
                                            spill_dir=os.path.join(tmp, "resume_table"))
        label_r, sel_r, _, pred_r = pipeline()
        wf_r = T.Workflow().set_input_dataset(cds_r).set_result_features(label_r, pred_r)
        t0 = time.perf_counter()
        clean = wf_r.train(device=dev)
        clean_s = time.perf_counter() - t0
        resume_dir = os.path.join(tmp, "resume")
        harness = FaultHarness()
        harness.script("ingest_chunk", [None, None,
                                        RuntimeError("non-retryable fault at chunk 2")])
        try:
            with harness:
                wf_r.train(resume=resume_dir, device=dev)
            killed = None
        except RuntimeError as e:
            killed = str(e)
        with open(os.path.join(resume_dir, "chunk_offsets.json")) as fh:
            offsets = json.load(fh)
        check(killed == "non-retryable fault at chunk 2" and list(offsets.values()) == [2],
              f"the first epoch killed at chunk 2 with 2 chunks committed: "
              f"{killed}, {offsets}")
        recorder = obs_flight.install_recorder(obs_flight.FlightRecorder())
        t0 = time.perf_counter()
        try:
            resumed = wf_r.train(resume=resume_dir, device=dev)
        finally:
            obs_flight.uninstall_recorder()
        resumed_s = time.perf_counter() - t0
        evs = recorder.events("chunk_resume")
        check([e["data"]["skipped_chunks"] for e in evs] == [2]
              and evs[0]["data"]["total_chunks"] == cds_r.n_chunks,
              f"the re-run records chunk_resume with 2 skipped: {evs}")
        check(_ooc_selection(resumed, sel_r) == _ooc_selection(clean, sel_r)
              and _ooc_states(resumed) == _ooc_states(clean),
              "the resumed model bitwise an uninterrupted chunked train's")
        c = {"rows": OOC_RESUME_ROWS, "chunks": cds_r.n_chunks,
             "uninterrupted_train_s": clean_s, "resumed_train_s": resumed_s,
             "chunk_resume": evs[0]["data"]}

        # (b) score_dataset over the chunked table, against the same rows'
        # records scored in memory in the same 8192-record batches
        splan = model_c.serving_plan(8, OOC_CHUNK, device=dev).warm()
        KE.reset_launch_counts()
        t0 = time.perf_counter()
        rows_c = splan.score_dataset(cds_r)
        score_s = time.perf_counter() - t0
        score_launches = KE.launch_counts()["encode_slots"]
        t0 = time.perf_counter()
        recs = splan._records_of(cds_r.materialize())
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_m = [r for i in range(0, len(recs), OOC_CHUNK)
                  for r in splan.score(recs[i:i + OOC_CHUNK])]
        mem_score_s = time.perf_counter() - t0
        check(rows_c == rows_m and len(rows_c) == OOC_RESUME_ROWS,
              "score_dataset's records equal in-memory scoring of the same rows")
        check(score_launches == cds_r.n_chunks,
              f"one encode launch per chunk: {score_launches} for {cds_r.n_chunks}")
        b = {"rows": OOC_RESUME_ROWS, "chunks": cds_r.n_chunks, "launches": score_launches,
             "score_dataset_records_per_s": OOC_RESUME_ROWS / score_s,
             "in_memory_records_per_s": OOC_RESUME_ROWS / mem_score_s,
             "in_memory_decode_s": decode_s, "prefetch": splan.last_prefetch}
        del cds_r, splan, recs, rows_c, rows_m

    # (e) the chunk tile's launch: 40 slots over OOC_CHUNK rows
    ins = tile_plan.encode_operands(ds.take(np.arange(OOC_CHUNK)))
    table = tile_plan._encode_table
    buf = encode_buffer(OOC_CHUNK, table.width, dev)
    KE.encode_slots(ins, table, buf)
    torch.cuda.synchronize()
    check(torch.equal(buf, KE.encode_slots_torch(ins, table)),
          "the chunk tile's encode launch bitwise its plain version")
    nbytes = KE.bound_bytes(OOC_CHUNK, table)
    e = {"rows": OOC_CHUNK, "slots": len(table), "columns": table.width,
         "ms": time_device_ms(lambda: KE.encode_slots(ins, table, buf)),
         "host_inclusive_ms": time_ms(lambda: KE.encode_slots(ins, table, buf)),
         "plain_ms": time_big_ms(lambda: KE.encode_slots_torch(ins, table, buf), runs=5),
         "library_ms": time_big_ms(lambda: _table_library(torch, ins, table), runs=5),
         "library": "per slot torch.nn.functional.one_hot(codes) or torch.bucketize + "
                    "one_hot (buckets only), then torch.cat",
         "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "in_epoch_ms": a["epoch_parts_s"].get("encode", 0.0) * 1e3 / a["chunks"],
         "launches_per_chunked_train": launches_c["encode_slots"], "max_abs_err": 0.0}
    del ins, buf, tile_plan
    out = {"data_host_s": data_s, "train": a, "budget": d, "resume": c, "score": b,
           "chunk_tile": e, "launches": launches_c,
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "ooc", **{k: v for k, v in out.items() if k != "train"}})
    return out


# -- 25. the deploy artifact store: a replica that boots without nvcc ----------

#: records the replica serves, and the fleet's flush: DEPLOY_BATCH requests
#: alternating between the two tenants, one sub-batch of each (one encode
#: launch each), flushed on size
DEPLOY_RECORDS = 2048
DEPLOY_BATCH = 256


def _deploy_child(argv) -> int:
    """Phase 25's replica, a process of its own: ``mode`` "artifact" boots a
    FleetServer of two tenants from the artifact dir (one by path, one by
    ArtifactStore), "cold" the same two without it.  It then serves the
    records, flushed on size, and prints one JSON line: wall-clock marks
    (imports done, model loaded, registered, first and last record scored),
    the compile events of the boot and of serving, hydrate's phases, the
    artifact_* flight events, the encode launches counted from the end of
    register, each tenant's plan metrics and nvcc's seconds; the records go
    to ``out``."""
    import torch

    mode, art, recs_path, out = argv
    from transmogrifai_tpu_torch.deploy import ArtifactStore, DeployBundle
    from transmogrifai_tpu_torch.obs import flight
    from transmogrifai_tpu_torch.perf import PhaseRecorder, measure_compiles, record_phases
    from transmogrifai_tpu_torch.perf.kernels import dispatch
    from transmogrifai_tpu_torch.perf.kernels import encode as KE
    from transmogrifai_tpu_torch.serve import FleetServer

    marks = {"imported": time.time()}
    with open(recs_path) as fh:
        records = json.load(fh)
    rec = flight.install_recorder(flight.FlightRecorder())
    model = DeployBundle.load(art).load_model()
    marks["model_loaded"] = time.time()
    torch.zeros(1, device="cuda")  # the CUDA context, timed apart from register
    torch.cuda.synchronize()
    marks["cuda_ready"] = time.time()
    phases = PhaseRecorder()
    modules = set(sys.modules)
    with measure_compiles() as probe:
        with FleetServer(max_batch=DEPLOY_BATCH, max_wait_ms=60_000, min_bucket=8,
                         max_bucket=1024) as fleet:
            with record_phases(phases):
                fleet.register("a", model, **({"artifact": art} if mode == "artifact" else {}))
                torch.cuda.synchronize()
                marks["registered_a"] = time.time()
                fleet.register("b", model, **({"artifact": ArtifactStore(art)}
                                              if mode == "artifact" else {}))
            torch.cuda.synchronize()
            marks["registered"] = time.time()
            # the modules registration imported, by package (torch's lazy ones)
            imported: dict = {}
            for m in set(sys.modules) - modules:
                top = ".".join(m.split(".")[:2]) if m.startswith("torch.") else m.split(".")[0]
                imported[top] = imported.get(top, 0) + 1
            boot = probe.to_dict()
            KE.reset_launch_counts()
            with measure_compiles() as serving:
                futs = [fleet.submit("ab"[i % 2], r) for i, r in enumerate(records)]
                futs[0].result(timeout=300)
                marks["first_scored"] = time.time()
                rows = [f.result(timeout=300) for f in futs]
                marks["last_scored"] = time.time()
            launches = KE.launch_counts()
            plans = {t: fleet.models.get(t).swapper.active.plan.metrics() for t in "ab"}
    with open(out, "w") as fh:
        json.dump(rows, fh)
    print(json.dumps({
        "mode": mode, "marks": marks, "boot": boot, "serve_events": serving.events,
        "register_imported": dict(sorted(imported.items(), key=lambda kv: -kv[1])[:12]),
        "phases_s": phases.report(6), "launches": launches,
        "scored_batches": {t: m["scored_batches"] for t, m in plans.items()},
        "bucket_batches": {t: m["bucket_batches"] for t, m in plans.items()},
        "staging_builds": {t: m["staging_builds"] for t, m in plans.items()},
        "hydrated": [e["data"] for e in rec.events("artifact_hydrated")],
        "refused": [e["data"] for e in rec.events("artifact_refused")],
        "missed": [e["data"] for e in rec.events("artifact_miss")],
        "nvcc_s": {n: i["seconds"] for n, i in dispatch.BUILD_INFO.items()},
        "build_dir": dispatch.build_dir()}), flush=True)
    return 0


def _spawn_deploy_child(mode: str, root: str, recs_path: str, tmp: str,
                        no_toolkit: bool):
    """Start :func:`_deploy_child` in a fresh process with an empty kernel
    build directory (and, with ``no_toolkit``, no CUDA toolkit: CUDA_HOME an
    empty dir, no nvcc on PATH, so any build raises KernelError); returns
    (the process, its records' file, the host clock at spawn)."""
    import shutil

    env = dict(os.environ)
    env["TMOG_TORCH_BUILD_DIR"] = os.path.join(tmp, f"kernels_{mode}")
    os.makedirs(env["TMOG_TORCH_BUILD_DIR"])
    if no_toolkit:
        env["CUDA_HOME"] = os.path.join(tmp, "no_cuda")
        os.makedirs(env["CUDA_HOME"], exist_ok=True)
        env.pop("CUDA_PATH", None)
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
        check(shutil.which("nvcc", path=env["PATH"]) is None,
              "the replica's PATH holds no nvcc")
    out = os.path.join(tmp, f"rows_{mode}.json")
    t_spawn = time.time()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--deploy-child",
                             mode, root, recs_path, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out, t_spawn


def _finish_deploy_child(mode: str, proc, out: str):
    """Wait for a replica; (its JSON line, its records)."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0,
          f"the {mode} replica exited {proc.returncode}: {stderr[-3000:]}")
    with open(out) as fh:
        rows = json.load(fh)
    return json.loads(stdout.strip().splitlines()[-1]), rows


def _boot_seconds(child: dict, t_spawn: float) -> dict:
    return {k: v - t_spawn for k, v in child["marks"].items()}


def phase_deploy(torch, KE, dev) -> dict:
    """Phase 25: the serving_wide model packed on the card, then booted in a
    fresh process with no nvcc and an empty build directory, against a
    cold boot that builds the encode kernel; refusals; the encode kernel
    under the hydrated plan."""
    import shutil
    import tempfile

    import numpy as np

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.deploy import ArtifactStore, DeployBundle, pack_model
    from transmogrifai_tpu_torch.obs import flight as obs_flight

    t_phase = time.perf_counter()
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    model = WorkflowModel.load(FIXTURE)
    tmp = tempfile.mkdtemp(prefix="tmog_deploy_")
    try:
        # 1. pack on the card
        root = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        bundle = pack_model(model, root, min_bucket=8, max_bucket=1024)
        pack_s = time.perf_counter() - t0
        mplan = bundle.plan
        check(mplan["buckets"] == [8 << i for i in range(8)]
              and sorted(mplan["libraries"]) == ["encode"],
              f"the artifact holds the ladder 8..1024 and the encode library: "
              f"{mplan['buckets']}, {sorted(mplan['libraries'])}")
        model_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(os.path.join(root, "model")) for f in fs)
        nbytes = {"buckets": sum(m["size"] for m in mplan["objects"].values()),
                  "libraries": {n: m["size"] for n, m in mplan["libraries"].items()},
                  "model": model_bytes,
                  "manifest": os.path.getsize(os.path.join(root, "manifest.json"))}

        # the live plan's records for the sub-batches the fleet serves
        records = make_records(schema, DEPLOY_RECORDS, np.random.default_rng(25))
        live = model.serving_plan(8, 1024).warm()
        subs = [list(range(k + t, k + DEPLOY_BATCH, 2))
                for k in range(0, DEPLOY_RECORDS, DEPLOY_BATCH) for t in (0, 1)]
        expected = [None] * DEPLOY_RECORDS
        for idx in subs:
            for i, row in zip(idx, live.score([records[i] for i in idx])):
                expected[i] = row
        want = json.loads(json.dumps(expected))
        recs_path = os.path.join(tmp, "records.json")
        with open(recs_path, "w") as fh:
            json.dump(records, fh)

        # the modules a first registration imports (torch's lazy ones, through
        # the fleet's static estimate) are read from a warm page cache by both
        # replicas, as after the script's earlier phases
        from transmogrifai_tpu_torch.checkers.plancheck import analyze_scoring_plan

        estimate = int(analyze_scoring_plan(live).peak_hbm_bytes)

        # 2-3. the replica (no nvcc, an empty build directory) and a cold boot
        # without the artifact (nvcc present, an empty build directory), side
        # by side on the host's cores
        spawned = {}
        try:
            for mode in ("artifact", "cold"):
                spawned[mode] = _spawn_deploy_child(mode, root, recs_path, tmp,
                                                    mode == "artifact")
            (child, rows), (cold, cold_rows) = (
                _finish_deploy_child(mode, *spawned[mode][:2]) for mode in ("artifact", "cold"))
        finally:
            for proc, _out, _t in spawned.values():  # a failed check leaves none running
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        t_spawn, t_cold = spawned["artifact"][2], spawned["cold"][2]
        boot_events = child["boot"]["events"]
        check("nvcc_build" not in boot_events and "nvcc_build" not in child["serve_events"],
              f"no nvcc build in the replica: {boot_events}")
        check(boot_events.get("library_load") == 1
              and child["boot"]["persistent_cache_hits"] == 1
              and child["boot"]["persistent_cache_misses"] == 0,
              f"one library load, a cache hit: {child['boot']}")
        check(child["serve_events"] == {},
              f"no compile event after register: {child['serve_events']}")
        check(len(child["hydrated"]) == 1 and child["hydrated"][0]["live_compile_buckets"] == []
              and child["hydrated"][0]["buckets"] == mplan["buckets"]
              and not child["refused"] and not child["missed"],
              f"one artifact_hydrated event, no live bucket: {child['hydrated']}")
        sub_batches = sum(child["scored_batches"].values())
        check(sub_batches == len(subs)
              and all(b == {str(DEPLOY_BATCH // 2): len(subs) // 2}
                      for b in child["bucket_batches"].values()),
              f"the replica served {len(subs)} sub-batches of {DEPLOY_BATCH // 2}: "
              f"{child['bucket_batches']}")
        check(child["launches"]["encode_slots"] == sub_batches,
              f"encode launches {child['launches']['encode_slots']} == sub-batches "
              f"{sub_batches}")
        check(child["staging_builds"]["b"] == 0,
              "the second tenant shares the first's staging")
        check(rows == want, "the replica's records == the live plan's (through JSON)")

        check(cold["boot"]["events"].get("nvcc_build") == 1 and cold["serve_events"] == {}
              and cold["launches"]["encode_slots"] == sum(cold["scored_batches"].values()),
              f"the cold boot built encode once and served without a compile event: "
              f"{cold['boot']['events']}, {cold['serve_events']}")
        check(cold_rows == want, "the cold replica's records == the live plan's")

        # 5. refusals in this process: a truncated bucket object and a
        # truncated library object
        refusals = {}
        first = [records[i] for i in subs[0]]
        for what in ("bucket", "library"):
            bad = os.path.join(tmp, f"bad_{what}")
            shutil.copytree(root, bad)
            meta = (DeployBundle.load(bad).plan["objects"]["128"] if what == "bucket"
                    else DeployBundle.load(bad).plan["libraries"]["encode"])
            with open(os.path.join(bad, meta["file"]), "r+b") as fh:
                fh.truncate(meta["size"] // 2)
            plan = model.serving_plan(8, 1024)
            rec = obs_flight.install_recorder(obs_flight.FlightRecorder())
            try:
                res = ArtifactStore(bad).hydrate(plan, tenant=what)
            finally:
                obs_flight.uninstall_recorder()
            evs = rec.events("artifact_refused")
            check(res["refused"] and res["hydrated"] == [] and len(evs) == 1
                  and evs[0]["data"]["code"] == "TM510",
                  f"a truncated {what} object refused with TM510: {res['reasons']}")
            plan.warm()
            check(json.loads(json.dumps(plan.score(first))) == [want[i] for i in subs[0]],
                  f"after the {what} refusal the live build scores bitwise")
            plan.release_executables()
            refusals[what] = res["reasons"][0]

        # 6. the encode kernel under a hydrated plan: the prefix's output
        # bitwise its plain version (the CPU plan) and the eager plan's
        hplan = model.serving_plan(8, 1024)
        res = ArtifactStore(root).hydrate(hplan)
        check(res["hydrated"] == mplan["buckets"], f"the parent hydrates: {res}")
        cpu_plan = model.serving_plan(8, 1024, device="cpu")
        hv, cv, lv = (p.prefix_outputs(first) for p in (hplan, cpu_plan, live))
        check(all(a.tobytes() == b.tobytes() == c.tobytes() and a.dtype == b.dtype
                  for a, b, c in zip(hv, cv, lv)),
              "the hydrated plan's prefix bitwise its plain version and the eager plan's")
        hplan.release_executables()
        live.release_executables()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {
        "records": DEPLOY_RECORDS, "sub_batches": sub_batches, "pack_s": pack_s,
        "artifact_bytes": nbytes, "plan_estimate_bytes": estimate,
        "boots": "the replica and the cold boot side by side, each its own process",
        "boot": {"seconds_from_spawn": _boot_seconds(child, t_spawn),
                 "hydrate_phases_s": child["phases_s"], "events": boot_events,
                 "register_imported_modules": child["register_imported"],
                 "launches": child["launches"], "build_dir_empty_at_start": True},
        "cold": {"seconds_from_spawn": _boot_seconds(cold, t_cold),
                 "register_imported_modules": cold["register_imported"],
                 "nvcc_s": cold["nvcc_s"], "events": cold["boot"]["events"],
                 "launches": cold["launches"]},
        "refusals": refusals,
        "kernel_check": {"max_abs_err": 0.0, "parity": "bitwise"},
        "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "deploy", **out})
    return out


# -- 26. the operator CLI and the kernel autotuner ------------------------------

#: phase 26's sweeps at the main path's shapes: K1's int8 level of phase 9's
#: RF CV (150 lanes x 16 nodes) and its float GBT level (3 x 2), K2 at the RF
#: CV's deepest level, K3 at 150 and 3 lanes, the encode kernel's 40 slots
#: over a served batch and over the training flush, and over (c)'s flush (so
#: a winner can apply in (c)'s train); beside each, PERF.md section 6's
#: bound of that shape (ms)
#: rows of (c)'s trains of phase 10's table (LR + RF + GBT, 2-fold CV)
CLI_TRAIN_ROWS = 1 << 16
CLI_SWEEPS = (
    ("hist", {"lanes": FOLDS * 50, "nodes": 16, "rows": FULL_ROWS, "features": D,
              "bins": N_BINS, "classes": 1, "int_exact": 1}, 0.466),
    ("hist", {"lanes": FOLDS, "nodes": 2, "rows": FULL_ROWS, "features": D,
              "bins": N_BINS, "classes": 1, "int_exact": 0}, 0.172),
    ("split", {"lanes": FOLDS * 50, "nodes": 32, "classes": 1, "features": D,
               "bins": N_BINS}, 0.0485),
    ("route", {"lanes": FOLDS * 50, "rows": FULL_ROWS, "features": D}, 0.536),
    ("route", {"lanes": FOLDS, "rows": FULL_ROWS, "features": D}, 0.0113),
    ("encode", {"rows": BATCH, "slots": 40, "width": 730}, 9.41e-04),
    ("encode", {"rows": RAW_ROWS, "slots": 40, "width": 728}, 0.2404),
    ("encode", {"rows": CLI_TRAIN_ROWS, "slots": 40, "width": 728}, None),
)
#: timed reps a candidate (min of them; its first launch excluded)
CLI_REPS = 5
#: timed reps a candidate in the sweeps of (c)'s own launch classes (they
#: pick each class's fastest non-default plan; one rep keeps them off the
#: host the children need)
CLI_TRAIN_REPS = 1
CLI_RF_GRID = {"num_trees": 50, "max_depth": 6}
CLI_GBT_GRID = {"num_rounds": 10, "max_depth": 3}
#: (d): rows of the table's CSV that `cli train` and `cli gen` read, records
#: `cli serve` replays (in full batches of CLI_SERVE_BATCH: the CPU plan
#: scores the same batches), labelled records a drift segment of the tail
CLI_CSV_ROWS = 1 << 14
CLI_SERVE_RECORDS = 2048
CLI_SERVE_BATCH = 256
CLI_FOLLOW_RECORDS = 256
#: `cli train` SIGKILLed at its sweep's second gather, after the first
#: family's journal commit (its arguments after ``-c``)
CLI_KILLED_TRAIN = (
    "import os, signal, sys\n"
    "from transmogrifai_tpu_torch.serve.faults import FaultHarness\n"
    "from transmogrifai_tpu_torch.cli import main\n"
    "kill = lambda ctx: os.kill(os.getpid(), signal.SIGKILL)\n"
    "with FaultHarness(seed=0).script('device_sync', [None, kill]):\n"
    "    main(sys.argv[1:])\n"
    "raise SystemExit('unreachable: SIGKILL should have landed')\n")
#: runs a generated project's App on the CPU (a rehearsal of phase 26 off the
#: card), its arguments after ``-c``
CLI_APP_ON_CPU = (
    "import runpy, sys\n"
    "from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device\n"
    "sys.argv = ['main.py'] + sys.argv[1:]\n"
    "with use_device('cpu'):\n"
    "    runpy.run_path('main.py', run_name='__main__')\n")
#: the autotuner's family of each kernel of the kernels line
_FAMILY_OF = {"hist_level": "hist", "split_scan": "split", "row_select_lanes": "route"}


def _autotune_line(cli: dict, family: str) -> list:
    """Phase 26's sweeps of one family for the kernels line: shape class,
    candidates, eligible, default and best ms, the winner, the bound."""
    return [{k: s[k] for k in ("class", "candidates", "eligible", "default_ms",
                               "best_ms", "best", "winner", "bound_ms",
                               "perf_md_bound_ms")}
            for s in cli["sweeps"] if s["family"] == family]


def _cli_sweep(torch, autotune, family: str, dims: dict, perf_bound, store: str,
               dev, reps: Optional[int] = None, several: bool = True) -> dict:
    """One sweep at ``dims`` on ``dev``; every candidate must be eligible
    (its output held to the plain version there by the sweep) and, where
    ``several``, the card must have more than the default to try.  ``best``
    is the fastest candidate, ``winner`` the one adopted (the default unless
    the fastest beats it by more than its reps' spread); ``runner_up`` the
    fastest non-default candidate."""
    t = time.perf_counter()
    dec = autotune.sweep(family, dims, store=store, device=dev, reps=reps or CLI_REPS)
    entry = autotune._read_entry(autotune._entry_path(dec.device_kind, family,
                                                      dec.shape_class, store))
    what = f"autotune {family} at {dims}"
    check(entry is not None and dec.verified, f"{what}: verified and stored")
    check(dec.eligible == dec.candidates
          and (dec.candidates > 1 or dev.type != "cuda" or not several),
          f"{what}: every candidate matches the plain version on the card "
          f"({dec.eligible} of {dec.candidates}): {entry and entry['trials']}")
    check(dec.default_seconds is not None, f"{what}: the default was timed")
    default = autotune.family_defaults(family, dec.shape_class)
    timed = sorted(entry["trials"], key=lambda tr: tr["seconds"])
    best = timed[0]
    runner = next((tr for tr in timed if tr["params"] != default), None)
    b = bound(entry["work"]["bytes"], entry["work"]["ops"])
    return {"family": family, "dims": dims, "class": dec.shape_class,
            "candidates": dec.candidates, "eligible": dec.eligible,
            "default": default, "winner": dec.params,
            "default_ms": dec.default_seconds * 1e3,
            "default_reps_ms": [r * 1e3 for r in next(
                tr["reps"] for tr in timed if tr["params"] == default)],
            "best": best["params"], "best_ms": best["seconds"] * 1e3,
            "best_reps_ms": [r * 1e3 for r in best["reps"]],
            "default_over_best": dec.default_seconds / best["seconds"],
            "runner_up": runner and runner["params"],
            "runner_up_ms": runner and runner["seconds"] * 1e3,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "perf_md_bound_ms": perf_bound,
            "trials": [{"params": tr["params"],
                        "ms": None if tr["seconds"] is None else tr["seconds"] * 1e3}
                       for tr in entry["trials"]],
            "sweep_s": time.perf_counter() - t}


def _cli_force(autotune, s: dict, store: str, dev) -> bool:
    """Write sweep ``s``'s fastest non-default candidate (verified on the
    card by that sweep) as the winner of its class in ``store``; False where
    the class had no other candidate."""
    if s["runner_up"] is None:
        return False
    kind = autotune.device_kind(dev)
    entry = {"schema": autotune.SCHEMA_VERSION, "device_kind": kind,
             "family": s["family"], "shape_class": s["class"],
             "params": s["runner_up"], "verified": True,
             "candidates": s["candidates"], "eligible": s["eligible"],
             "best_seconds": s["runner_up_ms"] / 1e3,
             "default_seconds": s["default_ms"] / 1e3, "dims": s["dims"]}
    autotune._write_atomic(autotune._entry_path(kind, s["family"], s["class"], store),
                           entry)
    return True


def _cli_table(tmp: str) -> str:
    """(d)'s table: phase 10's table as a CSV of CLI_CSV_ROWS rows."""
    import csv

    from torch_wide_data import FIXTURE_SHAPE, make_data

    cols, schema = make_data(CLI_CSV_ROWS, seed=63, **FIXTURE_SHAPE)
    names = [s["name"] for s in schema]
    table = os.path.join(tmp, "table.csv")
    with open(table, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(names)
        for i in range(CLI_CSV_ROWS):
            w.writerow(["" if cols[c][i] is None else cols[c][i] for c in names])
    return table


def _cli_tables(torch, dev, tmp: str) -> dict:
    """(d)'s other files: phase 10's records as JSONL (one file plain, one
    with a tenant column), and the continual base (trained on ``dev``) with
    its labelled tail and baseline."""
    import types

    import transmogrifai_tpu_torch as T
    import torch_stream_data as SD
    from torch_wide_data import FIXTURE_SHAPE, make_data
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.readers.base import rows_to_dataset
    from transmogrifai_tpu_torch.workflow import continual as TC
    from transmogrifai_tpu_torch.workflow.workflow import dedup_raw_features

    cols, schema = make_data(CLI_SERVE_RECORDS, seed=64, **FIXTURE_SHAPE)
    names = [s["name"] for s in schema]
    records = [{c: cols[c][i] for c in names if c != "label"}
               for i in range(CLI_SERVE_RECORDS)]
    recs = os.path.join(tmp, "records.jsonl")
    _write_jsonl(recs, records)
    tenants = os.path.join(tmp, "tenant_records.jsonl")
    _write_jsonl(tenants, [{"tenant": ("acme" if i % 2 else "globex"), **r}
                           for i, r in enumerate(records)])
    pkg = types.SimpleNamespace(
        FeatureBuilder=T.FeatureBuilder, transmogrify=T.transmogrify,
        BinaryClassificationModelSelector=T.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, Workflow=T.Workflow,
        rows_to_dataset=rows_to_dataset, dedup_raw_features=dedup_raw_features,
        continual=TC)
    base, _, _, snap = SD.continual_base(pkg, {"device": dev})
    base_dir = os.path.join(tmp, "continual_model")
    base.save(base_dir)
    baseline = os.path.join(tmp, "baseline.json")
    snap.save(baseline)
    stream = os.path.join(tmp, "stream.jsonl")
    _write_jsonl(stream, SD.make_records(CLI_FOLLOW_RECORDS, 51, shift=3.0)
                 + SD.make_records(CLI_FOLLOW_RECORDS, 53, shift=-3.0))
    return {"records": recs, "records_list": records,
            "tenant_records": tenants, "continual_model": base_dir,
            "baseline": baseline, "stream": stream}


#: phase 10's table at CLI_TRAIN_ROWS, made once for phases 26 and 28
_CLI_TABLE: dict = {}


def _cli_train_table():
    """(dataset, feature types, schema) of phase 10's table at
    CLI_TRAIN_ROWS rows (seed 61), made once a process."""
    if not _CLI_TABLE:
        import transmogrifai_tpu_torch as T
        from torch_wide_data import FIXTURE_SHAPE, make_data
        from transmogrifai_tpu_torch.types import feature_type_by_name

        cols, schema = make_data(CLI_TRAIN_ROWS, seed=61, **FIXTURE_SHAPE)
        ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
        _CLI_TABLE.update(ds=T.Dataset.from_features(cols, ftypes), ftypes=ftypes,
                          schema=schema)
    return _CLI_TABLE["ds"], _CLI_TABLE["ftypes"], _CLI_TABLE["schema"]


def _cli_trainer(torch, KE, dev, autotune):
    """(c)'s train of phase 10's table at CLI_TRAIN_ROWS under LR + RF + GBT
    with the winner store ``store_dir`` (an empty one: untuned): seconds,
    launches, launches that took a winner, winner and CV."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import wide_pipeline
    from transmogrifai_tpu_torch.models.trees import (
        GradientBoostedTreesClassifier,
        RandomForestClassifier,
    )
    from transmogrifai_tpu_torch.perf.kernels import dispatch

    ds, ftypes, schema = _cli_train_table()
    models = [(T.LogisticRegression(), [{"reg_param": 0.01}]),
              (RandomForestClassifier(), [dict(CLI_RF_GRID)]),
              (GradientBoostedTreesClassifier(), [dict(CLI_GBT_GRID)])]

    def train(store_dir, record=None):
        """``record`` (a dict) gains the dims of every launch class the
        train's launchers look up, by shape class."""
        os.environ["TMOG_AUTOTUNE_DIR"] = store_dir
        autotune.reset()
        token = autotune.tuning_token()
        label, sel, chk, pred = wide_pipeline(T, ftypes, schema, models=models)
        wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
        _reset_all(KE)
        autotune.applied_counts(reset=True)
        lookup = autotune.launch_params
        if record is not None:
            def recording(family, device, **dims):
                seen = record.setdefault(autotune.shape_class(family, device, **dims),
                                         [family, dims, 0])
                seen[2] += 1
                return lookup(family, device, **dims)
            autotune.launch_params = recording
        _sync(torch, dev)
        t = time.perf_counter()
        try:
            model = wf.train(device=dev)
            _sync(torch, dev)
        finally:
            autotune.launch_params = lookup
        seconds = time.perf_counter() - t
        summary = model.fitted[sel.uid].summary
        return {"model": model, "seconds": seconds, "launches": _all_counts(KE),
                "applied": autotune.applied_counts(reset=True), "token": token,
                "kernels_token": dispatch.cache_token(),
                "winner": summary.best_model_name,
                "cv": {(e.model_name, json.dumps(e.grid, sort_keys=True)):
                       [float(v) for v in e.metric_values]
                       for e in summary.validation_results},
                "width": len(model.fitted[chk.uid].kept_indices)}

    return train


def _cli_fingerprints(model, dev) -> tuple:
    plan = model.serving_plan(device=dev)
    fp = (plan.fingerprint, plan.content_fingerprint)
    plan.release_executables()
    return fp


def _cli_start(pool, steps: list, env: dict, here: str):
    """Run ``steps`` (argv, cwd or None, extra env or None) one after
    another in child processes on a worker of ``pool``; the future gives
    each step's rc, stdout, stderr's end and seconds."""
    def run():
        done = []
        for argv, cwd, extra in steps:
            t = time.perf_counter()
            p = subprocess.run(argv, cwd=cwd or here, env=dict(env, **(extra or {})),
                               capture_output=True, text=True, timeout=600)
            done.append({"rc": p.returncode, "out": p.stdout, "err": p.stderr[-4000:],
                         "seconds": time.perf_counter() - t})
        return done
    return pool.submit(run)


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.strip().startswith("{")]


def phase_cli(torch, KE, dev) -> dict:
    """The operator CLI and the kernel autotuner on the card.  (a) `cli tune
    run` of every family into a temporary store, then sweeps at the main
    path's shapes, every candidate held to its plain version; (b) a child
    reads the store with 0 sweeps and the same token; (c) phase 10's table
    trained untuned, recording its launch classes, each class swept, then
    trained again with each class's fastest non-default plan adopted, so
    that every family's launches run a plan other than the rules'; (d) `cli
    train --resume`
    killed and resumed beside an uninterrupted one, `cli serve` of one model
    and of two tenants with `cli top`, `--follow --refit`, and `cli gen`
    whose generated test runs, all in child processes.  The children whose
    inputs exist start first and import while (a) runs: the sweeps have the
    card to themselves (their launches are timed on the device, the host's
    enqueue held off the clock); (c) and the rest run beside the children."""
    import contextlib
    import io
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.cli.gen import main as cli_main
    from transmogrifai_tpu_torch.perf import autotune

    t_phase = time.perf_counter()
    # the children share the card with this process: hand back the blocks
    # earlier phases left cached (the multiclass train's peak is ~36 GB)
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="tmog_cli_")
    store = os.path.join(tmp, "store")
    empty = os.path.join(tmp, "no_store")
    # (c)'s sweeps of its own launch classes, and a store holding each
    # class's fastest non-default candidate
    own = os.path.join(tmp, "train_store")
    forced = os.path.join(tmp, "forced_store")
    env_before = os.environ.get("TMOG_AUTOTUNE_DIR")
    on = [] if dev.type == "cuda" else ["--device", str(dev)]
    cli = [sys.executable, "-m", "transmogrifai_tpu_torch.cli"]
    # the children run untuned (an empty store), the cold read on the store
    env = dict(os.environ, TMOG_AUTOTUNE_DIR=empty,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = {}
    pool = ThreadPoolExecutor(8)
    futs = {}
    try:
        # the children that read only the table start first: gen and the
        # resumed train are the phase's longest chains
        table, proj = _cli_table(tmp), os.path.join(tmp, "project")
        train_args = ["train", "--input", table, "--response", "label",
                      "--format", "json", *on]
        app_test = ([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                     "test_project.py"] if dev.type == "cuda" else
                    [sys.executable, "-c", CLI_APP_ON_CPU, "--run-type", "train",
                     "--model-location", os.path.join(tmp, "app_model")])
        t_kids = time.perf_counter()
        first = {
            "train": [(cli + train_args + [
                "--model-location", os.path.join(tmp, "m_whole"),
                "--resume", os.path.join(tmp, "ck_whole")], None, None)],
            "resume": [([sys.executable, "-c", CLI_KILLED_TRAIN] + train_args + [
                "--model-location", os.path.join(tmp, "m_resumed"),
                "--resume", os.path.join(tmp, "ck_resumed")], None, None),
                       (cli + train_args + [
                "--model-location", os.path.join(tmp, "m_resumed"),
                "--resume", os.path.join(tmp, "ck_resumed")], None, None)],
            "gen": [(cli + ["gen", "--input", table, "--response", "label",
                            "--output", proj, "--name", "cli-smoke"], None, None),
                    (app_test, proj, None)],
        }
        futs.update({k: _cli_start(pool, v, env, here) for k, v in first.items()})
        files = _cli_tables(torch, dev, tmp)
        follow = {
            "follow": [(cli + [
                "serve", "--model", files["continual_model"], "--records", files["stream"],
                "--output", os.path.join(tmp, "follow_scores.jsonl"),
                "--metrics-out", os.path.join(tmp, "follow_metrics.json"),
                "--follow", "--refit", "--offsets", os.path.join(tmp, "offsets.json"),
                "--baseline", files["baseline"], "--batch-interval", "0",
                "--max-empty-polls", "1", "--max-batch-records", "128",
                "--drift-min-records", "128", "--window-records", str(CLI_FOLLOW_RECORDS),
                "--shadow-records", "64", "--probation-batches", "2",
                "--checkpoint-dir", os.path.join(tmp, "follow_ckpts"),
                "--max-wait-ms", "1", *on], None, None)],
        }
        futs.update({k: _cli_start(pool, v, env, here) for k, v in follow.items()})

        # (a) every family at its default dims through the CLI, then the
        # main path's shapes
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["tune", "run", "--format", "json", "--store", store,
                           "--reps", str(CLI_REPS), *on])
        runs = [ln["sweep"] for ln in _json_lines(buf.getvalue())]
        check(rc == 0 and [r["family"] for r in runs] == list(autotune.FAMILIES)
              and all(r["verified"] and r["eligible"] == r["candidates"] for r in runs),
              f"cli tune run: rc {rc}, every family verified: {runs}")
        out["tune_run"] = {"seconds": time.perf_counter() - t,
                           "sweeps": [{k: r[k] for k in (
                               "family", "shapeClass", "params", "isDefault",
                               "candidates", "eligible", "bestSeconds",
                               "defaultSeconds")} for r in runs]}
        sweeps = []
        for family, dims, perf_bound in CLI_SWEEPS:
            s = _cli_sweep(torch, autotune, family, dims, perf_bound, store, dev)
            sweeps.append(s)
            emit({"phase": "cli.sweep", **s})
        out["sweeps"] = sweeps
        out["sweeps_s"] = time.perf_counter() - t
        # (b) the cold read of the complete store
        futs["show"] = _cli_start(pool, [(cli + ["tune", "show", "--format", "json",
                                                 "--store", store],
                                          None, {"TMOG_AUTOTUNE_DIR": store})], env, here)

        # (c) untuned (recording its launch classes), then the served
        # children, then each class swept, then tuned
        train = _cli_trainer(torch, KE, dev, autotune)
        classes = {}
        un = train(empty, record=classes)
        model_dir = os.path.join(tmp, "model")
        un["model"].save(model_dir)
        models_dir = os.path.join(tmp, "models")
        for tenant in ("acme", "globex"):
            un["model"].save(os.path.join(models_dir, tenant))
        served = {
            "serve": [(cli + ["serve", "--model", model_dir, "--records", files["records"],
                              "--output", os.path.join(tmp, "scores.jsonl"),
                              "--metrics-out", os.path.join(tmp, "serve_metrics.json"),
                              "--max-batch", str(CLI_SERVE_BATCH),
                              "--max-wait-ms", "60000", *on], None, None)],
            "fleet": [(cli + ["serve", "--models", models_dir,
                              "--records", files["tenant_records"],
                              "--output", os.path.join(tmp, "fleet_scores.jsonl"),
                              "--metrics-out", os.path.join(tmp, "fleet_metrics.json"),
                              "--max-batch", str(CLI_SERVE_BATCH), "--max-wait-ms", "2",
                              "--statusz-out", os.path.join(tmp, "statusz.jsonl"), *on],
                       None, None),
                      (cli + ["top", "--statusz", os.path.join(tmp, "statusz.jsonl"),
                              "--once", "--no-clear"], None, None)],
        }
        futs.update({k: _cli_start(pool, v, env, here) for k, v in served.items()})
        t = time.perf_counter()
        train_sweeps = [_cli_sweep(torch, autotune, family, dims, None, own, dev,
                                   reps=CLI_TRAIN_REPS, several=False)
                        for family, dims, _ in (classes[c] for c in sorted(classes))]
        forced_classes = {s["class"] for s in train_sweeps
                          if _cli_force(autotune, s, forced, dev)}
        train_sweeps_s = time.perf_counter() - t
        tu = train(forced)
        fp_adopted = _cli_fingerprints(tu["model"], dev)
        os.environ["TMOG_AUTOTUNE_DIR"] = empty
        autotune.reset()
        fp_untuned = _cli_fingerprints(tu["model"], dev)
        steps = {k: f.result() for k, f in futs.items()}
        children_s = time.perf_counter() - t_kids
        for name, done in steps.items():
            for i, st in enumerate(done):
                check(st["rc"] == 0 or (name == "resume" and i == 0),
                      f"cli child {name}[{i}] exited {st['rc']}: {st['err']}")

        # (c)'s checks
        check(un["winner"] == tu["winner"],
              f"tuned winner {tu['winner']} == untuned {un['winner']}")
        check(un["cv"].keys() == tu["cv"].keys(), "the same CV entries tuned and not")
        gbt_dev = 0.0
        for key, want in un["cv"].items():
            got = tu["cv"][key]
            if key[0] == "GradientBoostedTreesClassifier":
                gbt_dev = max([gbt_dev] + [abs(g - w) for g, w in zip(got, want)])
            else:
                check(got == want, f"{key[0]} CV metrics bitwise tuned and untuned: "
                      f"{got} vs {want}")
        check(gbt_dev <= 1e-3, f"GBT CV metrics within 1e-3 tuned and untuned: {gbt_dev}")
        for run in (un, tu):
            check(dev.type != "cuda" or all(run["launches"][k] > 0 for k in (
                "hist_level", "split_scan", "row_select_lanes", "encode_slots")),
                f"K1-K3 and the encode kernel launched: {run['launches']}")
        check(un["token"] == "" and not any(un["applied"].values())
              and "tune=" not in un["kernels_token"],
              f"the untuned train adopted nothing: {un['token']!r} {un['applied']}")
        tuned_any = bool(tu["token"])
        check(tuned_any == ("tune=" in tu["kernels_token"]),
              "the kernel token carries tune= exactly when a non-default winner "
              "is adopted")
        check(fp_adopted[1] == fp_untuned[1] and (fp_adopted[0] != fp_untuned[0]) == tuned_any,
              "a plan's fingerprint moves exactly when a non-default winner is "
              f"adopted (its content fingerprint never): token {tu['token']!r}")
        check(any(tu["applied"].values()) <= tuned_any,
              f"no winner applied without a tune= token: {tu['applied']}")
        # every family's launches took a non-default plan in the tuned train
        families = (autotune.FAMILIES if dev.type == "cuda" else ("hist", "route"))
        at_forced = {f: sum(n for c, (fam, _, n) in classes.items()
                            if fam == f and c in forced_classes) for f in families}
        check(tuned_any and all(tu["applied"].get(f, 0) > 0 for f in families),
              f"every family ran a non-default plan in the tuned train: applied "
              f"{tu['applied']}, lookups at the forced classes (untuned) {at_forced}")
        out["train"] = {
            "rows": CLI_TRAIN_ROWS, "untuned_s": un["seconds"], "tuned_s": tu["seconds"],
            "winner": tu["winner"], "gbt_cv_max_abs_dev": gbt_dev,
            "token": tu["token"], "applied": tu["applied"],
            "lookups_at_forced_classes": at_forced,
            "classes": len(classes), "forced_classes": len(forced_classes),
            "class_sweeps_s": train_sweeps_s,
            "class_sweeps": [{k: s[k] for k in (
                "class", "candidates", "default_ms", "best_ms", "winner",
                "runner_up", "runner_up_ms")} for s in train_sweeps],
            "launches_untuned": un["launches"], "launches": tu["launches"],
            "vector_width": un["width"]}
        del un, tu

        # (b) the same winners, 0 sweeps, the same token
        shown = _json_lines(steps["show"][0]["out"])
        child = {(w["winner"]["family"], w["winner"]["shape_class"]):
                 w["winner"]["params"] for w in shown if "winner" in w}
        mine = {(w["family"], w["shape_class"]): w["params"]
                for w in autotune.winners(store)}
        os.environ["TMOG_AUTOTUNE_DIR"] = store
        autotune.reset()
        token = autotune.tuning_token()
        check(child == mine and len(child) >= len(autotune.FAMILIES) + len(CLI_SWEEPS) - 1,
              f"the child read the store's {len(mine)} winners: {len(child)}")
        check(shown[-1]["sweeps"] == 0 and shown[-1]["token"] == token,
              f"the child swept nothing and adopted the same token: {shown[-1]} vs {token!r}")
        out["cold_read"] = {"winners": len(child), "sweeps": shown[-1]["sweeps"],
                            "token": token, "seconds": steps["show"][0]["seconds"]}
        os.environ["TMOG_AUTOTUNE_DIR"] = empty
        autotune.reset()

        # (d) train --resume killed and resumed == uninterrupted
        killed, resumed = steps["resume"]
        check(killed["rc"] == -signal.SIGKILL, f"cli train SIGKILLed: rc {killed['rc']}")
        whole = _json_lines(steps["train"][0]["out"])[-1]
        back = _json_lines(resumed["out"])[-1]
        check(back["journal"]["hits"] > 0, f"the resumed train hit the journal: {back}")
        check(back["bestModel"] == whole["bestModel"], "resumed winner == uninterrupted")
        sw = WorkflowModel.load(os.path.join(tmp, "m_whole")).summary().to_dict()
        sr = WorkflowModel.load(os.path.join(tmp, "m_resumed")).summary().to_dict()
        check(sw == sr, "the resumed model's CV metrics and winner bitwise the "
              "uninterrupted run's")
        out["train_cli"] = {"rows": CLI_CSV_ROWS, "kind": whole["kind"],
                            "winner": whole["bestModel"], "journal_whole": whole["journal"],
                            "journal_resumed": back["journal"],
                            "seconds": {"whole": steps["train"][0]["seconds"],
                                        "killed": killed["seconds"],
                                        "resumed": resumed["seconds"]}}

        # (d) serve --model: rows == the CPU plan's, batch by batch
        with open(os.path.join(tmp, "scores.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        cpu_plan = WorkflowModel.load(model_dir).serving_plan(device="cpu")
        recs = files["records_list"]
        check(len(rows) == len(recs), f"cli serve scored {len(rows)} of {len(recs)}")
        for lo in range(0, len(recs), CLI_SERVE_BATCH):
            want = json.loads(json.dumps(cpu_plan.score(recs[lo:lo + CLI_SERVE_BATCH]),
                                         default=str))
            check(rows[lo:lo + CLI_SERVE_BATCH] == want,
                  f"cli serve rows {lo}.. == the CPU plan's")
        with open(os.path.join(tmp, "serve_metrics.json")) as fh:
            sm = json.load(fh)
        # (d) serve --models + top
        with open(os.path.join(tmp, "fleet_scores.jsonl")) as fh:
            fleet_rows = [json.loads(ln) for ln in fh]
        check(len(fleet_rows) == len(recs) and not any("error" in r for r in fleet_rows),
              "cli serve --models scored every record")
        with open(os.path.join(tmp, "statusz.jsonl")) as fh:
            status = [json.loads(ln) for ln in fh if ln.strip()]
        check(status and set(status[-1]["tenants"]) == {"acme", "globex"},
              "the statusz stream names both tenants")
        frame = steps["fleet"][1]["out"]
        check("acme" in frame and "globex" in frame and "TENANT" in frame,
              f"cli top names both tenants: {frame}")
        out["serve"] = {"records": len(rows), "rows_equal_cpu": True,
                        "seconds": steps["serve"][0]["seconds"],
                        "fleet_top_seconds": [st["seconds"] for st in steps["fleet"]],
                        "batcher_completed": sm.get("batcher", {}).get("completed"),
                        "statusz_lines": len(status)}
        # (d) follow --refit
        with open(os.path.join(tmp, "follow_metrics.json")) as fh:
            fm = json.load(fh)
        with open(os.path.join(tmp, "follow_scores.jsonl")) as fh:
            n_follow = sum(1 for _ in fh)
        check(n_follow == 2 * CLI_FOLLOW_RECORDS, f"follow scored {n_follow}")
        check(fm["refits"] >= 1 and fm["last_refit"]["backend_compiles"] == 0,
              f"follow --refit refit with 0 kernel builds, loads or allocations: "
              f"{fm.get('refits')} {fm.get('last_refit')}")
        out["follow"] = {"records": n_follow, "refits": fm["refits"],
                         "promotions": fm["promotions"],
                         "refit_backend_compiles": fm["last_refit"]["backend_compiles"],
                         "seconds": steps["follow"][0]["seconds"]}
        # (d) gen + the generated test
        app_out = steps["gen"][1]["out"]
        check("passed" in app_out or dev.type != "cuda",
              f"the generated project's test passed: {app_out[-2000:]}")
        out["gen"] = {"seconds": [st["seconds"] for st in steps["gen"]],
                      "test": (app_out.strip().splitlines() or [""])[-1]}
        out["children_s"] = children_s
    finally:
        for f in futs.values():
            f.cancel()
        pool.shutdown(wait=True)
        if env_before is None:
            os.environ.pop("TMOG_AUTOTUNE_DIR", None)
        else:
            os.environ["TMOG_AUTOTUNE_DIR"] = env_before
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "cli", **out})
    return out


#: phase 27's cases held to a tolerance on the card against the CPU (every
#: other case is bitwise): the float fits' family rules (ROADMAP.md), with
#: the same random draws on both devices.  The linear fits' rule holds
#: coefficients to 1e-6; their outputs (margins over 6 features up to ~4,
#: and the probabilities) to 1e-5.  Multinomial LR's 200 Adam steps, like
#: the MLP's, hold to 1e-4 (its CV rule)
REGISTRY_TOL = {
    **{n: 1e-3 for n in ("GradientBoostedTreesClassifier",
                         "GradientBoostedTreesRegressor", "XGBoostClassifier",
                         "XGBoostRegressor")},
    **{n: 1e-5 for n in ("LogisticRegression", "LinearSVC", "LinearRegression",
                         "GeneralizedLinearRegression", "NaiveBayes")},
    "MultinomialLogisticRegression": 1e-4,
    "MultilayerPerceptronClassifier": WCV_MLP_TOL, "LDA": 5e-5, "Word2Vec": 1e-5,
}
#: the estimators whose fit runs on the device it is given
REGISTRY_DEVICE_FITS = ("LDA", "Word2Vec", "SanityChecker")
#: the tree families, whose fits launch K1-K3
REGISTRY_TREE_FITS = ("RandomForestClassifier", "RandomForestRegressor",
                      "DecisionTreeClassifier", "DecisionTreeRegressor",
                      "GradientBoostedTreesClassifier", "GradientBoostedTreesRegressor",
                      "XGBoostClassifier", "XGBoostRegressor")
REGISTRY_KERNELS = ("encode_slots", "left_closed", "hist_level", "split_scan",
                    "row_select_lanes")


def _registry_counts(KE) -> dict:
    counts = _all_counts(KE)
    return {**{k: counts[k] for k in REGISTRY_KERNELS if k in counts},
            "left_closed": KE.left_closed_launches}


def _registry_run(RC, pkg, name, dev):
    """Case ``name`` built, fitted on ``dev`` where it is an estimator and
    transformed there through one fused plan: (output column, fitted
    stage, the flush's profile record)."""
    from transmogrifai_tpu_torch.workflow.plan import fused_transform

    stage, ds, _flags = RC.build(pkg, name)
    model = stage.fit(ds, device=dev) if isinstance(stage, pkg.Estimator) else stage
    prof: list = []
    out = fused_transform(ds, [model], device=dev, profile=prof)[model.output_name]
    return out, model, prof[0]


def phase_registry(torch, KE, dev) -> dict:
    """Phase 27: every case of the registry sweep (tests/torch_registry_cases.py)
    with a device half, on the card and on the CPU in this process.  A case
    has a device half where its fit runs on the device it is given (the
    prediction families, the checker, LDA, Word2Vec) or its fitted stage
    runs in a plan's device prefix or scores on the device.  The output on
    the card must equal the CPU's, bitwise or to REGISTRY_TOL; a case whose
    device half is an encode slot must launch the encode kernel, a tree fit
    K1-K3, and every other device half must allocate on the card (its
    device work is torch ops: the reference's is XLA with no pallas_call).
    The random draws (bootstrap, Word2Vec, LDA) are made on the CPU and
    moved, so both devices start from the same ones; TF32 is off."""
    import importlib
    import pkgutil

    import torch_registry_cases as RC

    import transmogrifai_tpu_torch
    from transmogrifai_tpu_torch import types as TT
    from transmogrifai_tpu_torch.data import dataset as TD
    from transmogrifai_tpu_torch.features import builder as TFB
    from transmogrifai_tpu_torch.models import trees as TTR
    from transmogrifai_tpu_torch.models.base import PredictionEstimatorBase
    from transmogrifai_tpu_torch.ops import embeddings as TE
    from transmogrifai_tpu_torch.stages import base as TB
    from transmogrifai_tpu_torch.utils import vector_metadata as TVM

    t_phase = time.perf_counter()
    for m in pkgutil.walk_packages(transmogrifai_tpu_torch.__path__,
                                   prefix="transmogrifai_tpu_torch."):
        if "__main__" not in m.name:
            importlib.import_module(m.name)
    pkg = RC.namespace(TD, TB, TT, TVM, TFB)
    cpu = torch.device("cpu")
    seams = {(TTR, "draw_bootstrap"): TTR.draw_bootstrap,
             (TE, "draw_word2vec_init"): TE.draw_word2vec_init,
             (TE, "draw_lda_init"): TE.draw_lda_init}

    def on_cpu(real):
        def draw(*args):
            got = real(*args[:-1], cpu)
            if isinstance(got, tuple):
                return tuple(t.to(args[-1], copy=True) for t in got)
            return got.to(args[-1], copy=True)
        return draw

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for (mod, attr), real in seams.items():
        setattr(mod, attr, on_cpu(real))
    cases, totals, by_family = [], dict.fromkeys(REGISTRY_KERNELS, 0), {}
    cpu_s = 0.0
    try:
        for name in sorted(RC.CASES):
            t0 = time.perf_counter()
            want, cmodel, cprof = _registry_run(RC, pkg, name, cpu)
            cpu_s += time.perf_counter() - t0
            fit_half = name in REGISTRY_DEVICE_FITS or issubclass(
                pkg.STAGE_REGISTRY[name], PredictionEstimatorBase)
            prefix = cprof["host_stages"] == 0
            scores = bool(getattr(cmodel, "scores_on_device", False))
            if not (fit_half or prefix or scores):
                continue
            slots = prefix and cmodel.device_slot_specs() is not None
            _reset_all(KE)
            allocs0 = torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)
            t0 = time.perf_counter()
            got, _model, prof = _registry_run(RC, pkg, name, dev)
            _sync(torch, dev)
            dev_s = time.perf_counter() - t0
            allocs = torch.cuda.memory_stats(dev).get("allocation.all.allocated",
                                                      0) - allocs0
            launches = _registry_counts(KE)
            diff = RC.column_diff(got, want)
            tol = REGISTRY_TOL.get(name, 0.0)
            half = "+".join(h for h, on in (("fit", fit_half), ("prefix", prefix),
                                            ("scores", scores)) if on)
            check(diff <= tol, f"registry {name}: card vs CPU max |diff| {diff} "
                               f"over {tol}")
            check(prof["host_stages"] == cprof["host_stages"],
                  f"registry {name}: the card's plan split as the CPU's")
            kernels = sum(launches.values())
            if slots:
                check(launches["encode_slots"] >= 1,
                      f"registry {name}: an encode slot launched the encode "
                      f"kernel: {launches}")
            if name in REGISTRY_TREE_FITS:
                check(min(launches[k] for k in ("hist_level", "split_scan",
                                                "row_select_lanes")) >= 1,
                      f"registry {name}: the tree fit launched K1-K3: {launches}")
            check(allocs > 0 or kernels > 0,
                  f"registry {name}: its device half ran on the card")
            route = "kernel" if kernels else "torch"
            for k, v in launches.items():
                totals[k] += v
            fam = "bitwise" if tol == 0.0 else name
            by_family[fam] = max(by_family.get(fam, 0.0), diff)
            line = {"phase": "registry_case", "name": name, "half": half,
                    "route": route, "device_s": dev_s, "launches": launches,
                    "device_allocations": allocs, "max_abs_diff": diff, "tol": tol}
            emit(line)
            cases.append(line)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for (mod, attr), real in seams.items():
            setattr(mod, attr, real)
    out = {"phase": "registry", "cases": len(RC.CASES), "device_cases": len(cases),
           "kernel_cases": sum(c["route"] == "kernel" for c in cases),
           "launches": totals, "max_abs_diff": by_family,
           "device_s": sum(c["device_s"] for c in cases), "cpu_s": cpu_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# -- 28. static analysis --------------------------------------------------------

#: (d)'s lint children: the port's code with every rule, and the serving
#: model's cost at a budget (its arguments after the module)
STATIC_CODE_SKIP = ("fixtures", "__pycache__")


def _static_code_paths(here: str) -> list:
    """``--path`` arguments for the port's code: every entry of the package
    holding Python source but ``fixtures/`` (the JAX package's committed
    outputs, among them a generated numpy scorer kept byte-equal to the
    reference's)."""
    pkg = os.path.join(here, "transmogrifai_tpu_torch")
    out = []
    for name in sorted(os.listdir(pkg)):
        p = os.path.join(pkg, name)
        if name in STATIC_CODE_SKIP:
            continue
        if name.endswith(".py") or (os.path.isdir(p) and any(
                f.endswith(".py") for _r, _d, fs in os.walk(p) for f in fs)):
            out += ["--path", p]
    return out


def _static_child(argv: list, here: str):
    return subprocess.Popen([sys.executable, "-m", "transmogrifai_tpu_torch.cli",
                             "lint", *argv], cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": here})


def _static_peak(torch, dev, fn):
    """(measured peak rise in bytes, CUDA-event ms, fn's result) of ``fn``
    on the card."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base, start.elapsed_time(end), out


def _static_bound_ms(flops: int, nbytes: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3


def phase_static(torch, KE, dev) -> dict:
    """Phase 28: validate, lint and the op-graph corpus on the card: (a)
    zero cost, (b) the static cost beside the card's, (c) the strict gate,
    (d) the CLI and the corpus captured with CUDA operands."""
    import gc

    import transmogrifai_tpu_torch as T
    from torch_wide_data import wide_pipeline
    from transmogrifai_tpu_torch.checkers import irsnap
    from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
    from transmogrifai_tpu_torch.checkers.plancheck import analyze_transform_plan
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.models.trees import (
        GradientBoostedTreesClassifier,
        RandomForestClassifier,
    )
    from transmogrifai_tpu_torch.perf.timers import measure_compiles
    from transmogrifai_tpu_torch.stages.base import UnaryTransformer
    from transmogrifai_tpu_torch.types import Real, RealNN
    from transmogrifai_tpu_torch.workflow.plan import plan_for_features

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    model = T.WorkflowModel.load(FIXTURE)
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema_wide = json.load(fh)
    ds, ftypes, schema = _cli_train_table()   # phase 26's table
    models = [(T.LogisticRegression(), [{"reg_param": 0.01}]),
              (RandomForestClassifier(), [dict(CLI_RF_GRID)]),
              (GradientBoostedTreesClassifier(), [dict(CLI_GBT_GRID)])]

    # (a) zero cost: validate of the unfitted pipeline and of the served
    # model, and the corpus build, make no launch, no compile event and no
    # allocation on the card
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema, models=models)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    _sync(torch, dev)
    _reset_all(KE)
    torch.cuda.reset_peak_memory_stats(dev)
    peak0 = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    with measure_compiles() as probe:
        rep_wf = wf.validate(cost=True, host_budget=float(64 << 30), rows=CLI_TRAIN_ROWS)
        t1 = time.perf_counter()
        rep_model = model.validate(serving=True, cost=True, hbm_budget=float(total_mem))
        t2 = time.perf_counter()
        corpus, skipped = irsnap.build_corpus()
        t3 = time.perf_counter()
    launches = _all_counts(KE)
    check(all(v == 0 for v in launches.values()), f"static analysis launched: {launches}")
    check(probe.events == {}, f"static analysis compile events: {probe.events}")
    check(torch.cuda.max_memory_allocated(dev) == peak0,
          "static analysis allocated on the card")
    check(not rep_model.errors(), f"serving_wide at the card's memory: {rep_model.pretty()}")
    check(sorted(d.code for d in rep_wf.errors()) == ["TM606"],
          f"the unfitted pipeline's armed host budget fails closed: {rep_wf.pretty()}")
    check(skipped == [] and len(corpus) == 19, f"corpus families {sorted(corpus)}")
    cost = rep_model.plan_cost
    zero = {"launches": sum(launches.values()), "compile_events": probe.events,
            "peak_allocated_change": torch.cuda.max_memory_allocated(dev) - peak0,
            "workflow_validate_s": t1 - t0, "model_validate_s": t2 - t1,
            "corpus_s": t3 - t2, "families": len(corpus),
            "workflow_codes": sorted(d.code for d in rep_wf),
            "model_codes": sorted(d.code for d in rep_model)}
    emit({"phase": "static_zero_cost", **zero})

    # (d), started now: the lint children run beside (b) and (c)
    half = cost.peak_hbm_bytes / 2
    kids = {
        "code": _static_child([*_static_code_paths(here), "--all-functions",
                               "--concurrency", "--threads"], here),
        "model_card": _static_child(["--model", FIXTURE, "--serving", "--cost",
                                     "--hbm-budget", str(float(total_mem)),
                                     "--format", "json"], here),
        "model_half": _static_child(["--model", FIXTURE, "--serving", "--cost",
                                     "--hbm-budget", str(half), "--format", "json"],
                                    here),
    }

    # (c) the strict gate: a planted leak refused before anything runs, then
    # strict and unstrict trains of one seed
    class LabelGrab(UnaryTransformer):
        """Consumes the response as a plain input: the label leaks."""

        input_types = (RealNN,)
        output_type = Real
        allow_label_as_input = True

        def transform_columns(self, cols, dataset):
            return Column.from_values(Real, list(cols[0].data))

    l_label, _s, _c, _p = wide_pipeline(T, ftypes, schema, models=models)
    leak = l_label.transform_with(LabelGrab())
    leak_pred = l_label.transform_with(
        T.BinaryClassificationModelSelector.with_cross_validation(
            num_folds=2, models=[models[0]]), T.transmogrify([leak]))
    _reset_all(KE)
    torch.cuda.reset_peak_memory_stats(dev)
    peak0 = torch.cuda.max_memory_allocated(dev)
    with measure_compiles() as probe:
        try:
            T.Workflow().set_input_dataset(ds).set_result_features(
                l_label, leak_pred).train(device=dev, strict=True)
            refused = []
        except OpCheckError as e:
            refused = sorted({d.code for d in e.report.errors()})
    check(refused == ["TM401"], f"the planted leak's refusal: {refused}")
    check(sum(_all_counts(KE).values()) == 0 and probe.events == {}
          and torch.cuda.max_memory_allocated(dev) == peak0,
          "the planted leak refused before any launch or allocation")

    def train(strict: bool):
        label_, sel_, chk_, pred_ = wide_pipeline(T, ftypes, schema, models=models)
        wf_ = T.Workflow().set_input_dataset(ds).set_result_features(label_, pred_)
        _sync(torch, dev)
        _reset_all(KE)
        t = time.perf_counter()
        m = wf_.train(device=dev, strict=strict)
        _sync(torch, dev)
        summ = m.fitted[sel_.uid].summary
        return {"model": m, "seconds": time.perf_counter() - t,
                "launches": _all_counts(KE), "left_closed": KE.left_closed_launches,
                "winner": summ.best_model_name,
                "cv": {(e.model_name, json.dumps(e.grid, sort_keys=True)):
                       [float(v) for v in e.metric_values]
                       for e in summ.validation_results}}

    loose = train(False)
    strict = train(True)
    gbt_dev = 0.0
    for key, vals in loose["cv"].items():
        got = strict["cv"][key]
        if key[0].startswith("GradientBoosted"):
            gbt_dev = max([gbt_dev] + [abs(a - b) for a, b in zip(vals, got)])
        else:
            check(vals == got, f"strict train CV {key} bitwise: {vals} vs {got}")
    check(gbt_dev <= 1e-3, f"strict train GBT CV within 1e-3: {gbt_dev}")
    check(strict["winner"] == loose["winner"], "strict train winner")
    for k in ("hist_level", "split_scan", "row_select_lanes", "encode_slots"):
        check(strict["launches"][k] == loose["launches"][k] > 0,
              f"{k} launches strict {strict['launches'][k]} == unstrict "
              f"{loose['launches'][k]} > 0")
    emit({"phase": "static_strict", "refused": refused,
          "strict_s": strict["seconds"], "unstrict_s": loose["seconds"],
          "winner": strict["winner"], "gbt_cv_max_dev": gbt_dev,
          "launches": strict["launches"], "launches_unstrict": loose["launches"]})

    # (b) the static cost beside the card: each bucket of serving_wide's
    # ladder through a fresh plan, then the training flush of the table
    records = make_records(schema_wide, max(b.bucket for b in cost.buckets),
                           __import__("numpy").random.default_rng(28))
    buckets = []
    for bc in cost.buckets:
        plan = model.serving_plan(device=dev)
        rise, ev_ms, _ = _static_peak(torch, dev, lambda: plan.score(records[:bc.bucket]))
        dev_ms = plan.last_timings["device_ms"]
        plan.release_executables()
        del plan
        gc.collect()
        bound = _static_bound_ms(bc.flops, bc.bytes_read + bc.bytes_written)
        check(bc.peak_hbm_bytes >= rise,
              f"static peak {bc.peak_hbm_bytes} >= measured rise {rise} at {bc.bucket}")
        buckets.append({"bucket": bc.bucket, "static_flops": bc.flops,
                        "static_bytes": bc.bytes_read + bc.bytes_written,
                        "static_bound_ms": bound, "device_ms": dev_ms,
                        "batch_event_ms": ev_ms,
                        "time_ratio": bound / dev_ms if dev_ms else None,
                        "static_peak_bytes": bc.peak_hbm_bytes, "peak_rise_bytes": rise,
                        "peak_ratio": rise / bc.peak_hbm_bytes})
    fitted = strict["model"]
    tplan = plan_for_features(ds, fitted.result_features, fitted.fitted, device=dev)
    tcost = analyze_transform_plan(tplan, ds)
    tb = tcost.buckets[0]
    rise, ev_ms, _ = _static_peak(torch, dev, lambda: tplan.apply_prefix(ds))
    flush_dev_ms = tplan.last_timings["device_s"] * 1e3
    check(tb.peak_hbm_bytes >= rise,
          f"flush static peak {tb.peak_hbm_bytes} >= measured rise {rise}")
    fbound = _static_bound_ms(tb.flops, tb.bytes_read + tb.bytes_written)
    flush = {"rows": tb.bucket, "static_flops": tb.flops,
             "static_bytes": tb.bytes_read + tb.bytes_written,
             "static_bound_ms": fbound, "device_ms": flush_dev_ms,
             "encode_ms": tplan.last_timings["encode_ms"], "apply_event_ms": ev_ms,
             "time_ratio": fbound / flush_dev_ms if flush_dev_ms else None,
             "static_peak_bytes": tb.peak_hbm_bytes, "peak_rise_bytes": rise,
             "peak_ratio": rise / tb.peak_hbm_bytes}
    del tplan
    emit({"phase": "static_cost", "card": gpu_line(),
          "timing": "device_ms: the plan's CUDA-event device part of one batch; "
                    "flush device_ms: the synchronized device part of "
                    "apply_prefix; time_ratio: static bound / measured "
                    "(not gated: a batch sits in L2)",
          "buckets": buckets, "flush": flush,
          "ridge_flops_per_byte": F32_OPS_PER_S / HBM_BYTES_PER_S})

    # (d) the corpus captured with CUDA operands, against the goldens
    t_c = time.perf_counter()
    diff, _current = irsnap.check_ir_corpus(device=str(dev))
    counts = diff.to_dict()["counts"]
    check(counts.get("TM700", 0) == 0 and counts.get("TM704", 0) == 0,
          f"the card's corpus against the goldens: {counts}")
    drift = [d.message for d in diff.diagnostics if d.code in ("TM701", "TM702")]
    outs = {}
    for name, proc in kids.items():
        try:
            o, e = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            o, e = proc.communicate()
        outs[name] = (proc.returncode, o, e)
    check(outs["code"][0] == 0, f"lint of the port's code: rc {outs['code'][0]}\n"
          f"{outs['code'][1][-3000:]}{outs['code'][2][-2000:]}")
    check(outs["model_card"][0] == 0, f"lint at the card's memory: {outs['model_card']}")
    half_codes = [json.loads(ln).get("code") for ln in outs["model_half"][1].splitlines()
                  if ln.startswith("{")]
    check(outs["model_half"][0] == 1 and "TM601" in half_codes,
          f"lint at half the estimate: rc {outs['model_half'][0]} {half_codes}")
    thread_line = next((ln for ln in outs["code"][1].splitlines()
                        if ln.startswith("Thread model:")), "")
    out = {"zero_cost": zero, "strict": {k: strict[k] for k in ("seconds", "launches")},
           "launches_static": {**strict["launches"], "left_closed": strict["left_closed"]},
           "corpus": {"compared": diff.compared, "changed": diff.changed,
                      "counts": counts, "drift": drift,
                      "torch": [diff.golden_torch_version, diff.current_torch_version],
                      "seconds": time.perf_counter() - t_c},
           "lint": {"code_rc": outs["code"][0], "thread_model": thread_line,
                    "model_card_rc": outs["model_card"][0],
                    "model_half_rc": outs["model_half"][0],
                    "half_budget_bytes": half, "static_peak_bytes": cost.peak_hbm_bytes},
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "static_cli", **{k: out[k] for k in ("corpus", "lint")},
          "phase_s": out["phase_s"]})
    return out


# ---------------------------------------------------------------------------
# 29. mesh: data-parallel training over torch.distributed ranks
# ---------------------------------------------------------------------------

#: each rank's process-group timeout and the phase's wall limit on its ranks
MESH_GROUP_TIMEOUT_S = 60
MESH_WALL_S = 240


def _mesh_models():
    """Phase 26's families over its table: LR, RF CLI_RF_GRID, GBT
    CLI_GBT_GRID (by 2-fold CV)."""
    import transmogrifai_tpu_torch as T
    from transmogrifai_tpu_torch.models.trees import (
        GradientBoostedTreesClassifier,
        RandomForestClassifier,
    )

    return [(T.LogisticRegression(), [{"reg_param": 0.01}]),
            (RandomForestClassifier(), [dict(CLI_RF_GRID)]),
            (GradientBoostedTreesClassifier(), [dict(CLI_GBT_GRID)])]


def _mesh_train(torch, KE, dev, probe: bool = False) -> dict:
    """One train of phase 26's table (LR + RF + GBT) on ``dev`` under the
    ambient mesh (or none): seconds, launches, CV, winner, the winner's and
    the checker's fitted numbers.  ``probe`` times each level's histogram
    (K1, synchronised) and its reduction over the data group, with the
    histogram's bytes (a timed run: each is waited for)."""
    import numpy as np

    import transmogrifai_tpu_torch as T
    from torch_wide_data import wide_pipeline
    from transmogrifai_tpu_torch.models import trees as TT
    from transmogrifai_tpu_torch.parallel import mesh as PM

    ds, ftypes, schema = _cli_train_table()
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema, models=_mesh_models())
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    levels: list = []
    hist0, reduce0 = TT._khist.hist_level, PM.reduce_rows
    if probe:
        def hist_timed(*a, **kw):
            _sync(torch, dev)
            t = time.perf_counter()
            out = hist0(*a, **kw)
            _sync(torch, dev)
            levels.append({"k1_ms": (time.perf_counter() - t) * 1e3,
                           "bytes": out.numel() * out.element_size(),
                           "dtype": str(out.dtype).replace("torch.", "")})
            return out

        def reduce_timed(t_, mesh=None):
            if not (levels and "reduce_ms" not in levels[-1]
                    and t_.numel() * t_.element_size() == levels[-1]["bytes"]):
                return reduce0(t_, mesh)
            _sync(torch, dev)
            t = time.perf_counter()
            out = reduce0(t_, mesh)
            _sync(torch, dev)
            levels[-1]["reduce_ms"] = (time.perf_counter() - t) * 1e3
            return out

        TT._khist.hist_level, PM.reduce_rows = hist_timed, reduce_timed
    _reset_all(KE)
    _sync(torch, dev)
    t = time.perf_counter()
    try:
        model = wf.train(device=dev)
        _sync(torch, dev)
    finally:
        TT._khist.hist_level, PM.reduce_rows = hist0, reduce0
    seconds = time.perf_counter() - t
    summary = model.fitted[sel.uid].summary
    win = _winner_arrays(model, sel)
    checker = model.fitted[chk.uid]
    corr = checker.summary.correlations_feature
    return {"seconds": seconds,
            "launches": {**_all_counts(KE), "left_closed": KE.left_closed_launches},
            "winner": summary.best_model_name,
            "failed": list(summary.failed_models),
            "cv": {(e.model_name, json.dumps(e.grid, sort_keys=True)):
                   [float(v) for v in e.metric_values]
                   for e in summary.validation_results},
            "digest": hashlib.sha256(b"".join(
                k.encode() + (v if isinstance(v, bytes) else v.encode())
                for k, v in sorted(win.items()))).hexdigest(),
            "kept": list(checker.kept_indices),
            "corr": None if corr is None else np.asarray(corr, np.float32),
            "levels": levels}


def _mesh_child(argv) -> int:
    """One rank of phase 29: join the group (``mode`` "nccl" or "gloo"),
    build the global mesh, train phase 26's table under it and pickle what
    it saw to ``out`` (launches, collectives, CV, the winner's digest, the
    checker's matrix, the probed levels)."""
    import pickle

    import torch

    mode, rank, world, init, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    from transmogrifai_tpu_torch.parallel import collectives as C
    from transmogrifai_tpu_torch.parallel import distributed
    from transmogrifai_tpu_torch.parallel import mesh as PM
    from transmogrifai_tpu_torch.perf.kernels import encode as KE

    t0 = time.perf_counter()
    distributed.initialize(f"file://{init}", world, rank, backend=mode)
    mesh = distributed.global_mesh()
    dev = mesh.device
    check(dev.type == "cuda", f"rank {rank} resolves the card, not {dev}")
    _cli_train_table()
    ready = time.perf_counter() - t0
    C.reset_collective_counts()
    with PM.use_mesh(mesh):
        res = _mesh_train(torch, KE, dev, probe=True)
        res["token"] = PM.mesh_token()
    res.update(rank=rank, mode=mode, world=world, ready_s=ready,
               collectives=C.collective_counts(), device=str(dev),
               backend=mesh.backend,
               device_mesh=type(mesh.device_mesh).__name__)
    import torch.distributed as dist

    dist.barrier()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()
    return 0


def _spawn_mesh(mode: str, world: int, tmp: str) -> list:
    """Start ``world`` ranks of :func:`_mesh_child` sharing card 0; returns
    [(process, its result file, its stderr file)]."""
    init = os.path.join(tmp, f"rendezvous_{mode}")
    env = dict(os.environ, LOCAL_RANK="0", OMP_NUM_THREADS="2",
               TMOG_GROUP_TIMEOUT_S=str(MESH_GROUP_TIMEOUT_S))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    ranks = []
    for r in range(world):
        out = os.path.join(tmp, f"{mode}{r}.pkl")
        err = open(os.path.join(tmp, f"{mode}{r}.err"), "w+")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--mesh-child", mode, str(r), str(world), init, out],
                                env=env, stdout=subprocess.DEVNULL, stderr=err)
        ranks.append((proc, out, err))
    return ranks


def _finish_mesh(groups: dict, deadline: float) -> dict:
    """Wait for every rank of every group; a rank that fails, or a group
    past ``deadline``, kills every rank and fails the phase."""
    import pickle

    procs = [(m, p) for m, ranks in groups.items() for p, _, _ in ranks]
    failed = None
    try:
        while any(p.poll() is None for _, p in procs):
            bad = [(m, p) for m, p in procs if p.poll() not in (None, 0)]
            if bad:
                failed = f"a {bad[0][0]} rank exited {bad[0][1].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the mesh ranks ran past {MESH_WALL_S} s"
                break
            time.sleep(0.1)
        bad = [(m, p) for m, p in procs if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"a {bad[0][0]} rank exited {bad[0][1].returncode}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        for _, p in procs:
            p.wait()
    if failed is not None:
        tails = []
        for m, ranks in groups.items():
            for r, (_, _, err) in enumerate(ranks):
                err.seek(0)
                tails.append(f"--- {m} rank {r} ---\n{err.read()[-2500:]}")
        raise RuntimeError(f"check failed: {failed}\n" + "\n".join(tails))
    out = {}
    for m, ranks in groups.items():
        out[m] = []
        for _, path, _ in ranks:
            with open(path, "rb") as fh:
                out[m].append(pickle.load(fh))
    return out


def _mesh_cv_rules(got: dict, want: dict, what: str) -> dict:
    """(a)'s rules: RF CV bitwise, GBT within 1e-3, LR within 1e-4;
    returns the largest difference by family."""
    import numpy as np

    check(set(got) == set(want), f"{what}: the same candidates")
    diffs: dict = {}
    for key, ref in want.items():
        fam = key[0]
        d = float(np.max(np.abs(np.asarray(got[key]) - np.asarray(ref))))
        diffs[fam] = max(diffs.get(fam, 0.0), d)
        if fam == "RandomForestClassifier":
            check(got[key] == ref, f"{what}: RF CV bitwise ({got[key]} vs {ref})")
        elif fam == "GradientBoostedTreesClassifier":
            check(d <= 1e-3, f"{what}: GBT CV within 1e-3 ({d})")
        else:
            check(d <= 1e-4, f"{what}: {fam} CV within 1e-4 ({d})")
    return diffs


def phase_mesh(torch, KE, dev) -> dict:
    """Phase 29: data-parallel training over a torch.distributed mesh.

    (a) one rank on NCCL and (b) two ranks sharing the card over gloo (NCCL
    refuses two ranks on one device) each run ``distributed.initialize`` ->
    ``global_mesh`` -> ``use_mesh`` -> ``Workflow.train`` on phase 26's
    table (CLI_TRAIN_ROWS rows, LR + RF CLI_RF_GRID + GBT CLI_GBT_GRID) in
    child processes of their own, while this process trains the table
    without a mesh.  Gates: RF CV bitwise, GBT within 1e-3, LR within 1e-4
    and the same winner as the unmeshed train; NCCL collectives counted
    (and no other backend) in (a); every rank of (b) launches K1, K2, K3
    and the encode kernel, holds a bitwise-equal model, and its checker's
    ring correlation is within 1e-5 of the one-card product.  (c) prints,
    ungated, the deepest RF level's histogram bytes, its reduction time and
    its K1 time per rank."""
    import shutil
    import tempfile

    import numpy as np

    from transmogrifai_tpu_torch.perf.kernels import dispatch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()   # the ranks share the card with this process
    dispatch.build(["encode", "trees"])   # the ranks load what this built
    _cli_train_table()
    tmp = tempfile.mkdtemp(prefix="tmog_mesh_")
    try:
        groups = {"nccl": _spawn_mesh("nccl", 1, tmp),
                  "gloo": _spawn_mesh("gloo", 2, tmp)}
        deadline = time.monotonic() + MESH_WALL_S
        try:
            plain = _mesh_train(torch, KE, dev)
        except BaseException:
            for ranks in groups.values():
                for p, _, _ in ranks:
                    p.kill()
            raise
        ranks = _finish_mesh(groups, deadline)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    (a,) = ranks["nccl"]
    b = ranks["gloo"]

    def deepest(r):
        rf = [lv for lv in r["levels"] if lv["dtype"] == "int32" and "reduce_ms" in lv]
        lv = max(rf, key=lambda e: e["bytes"]) if rf else {}
        return {"hist_bytes": lv.get("bytes"), "allreduce_ms": lv.get("reduce_ms"),
                "k1_ms": lv.get("k1_ms"),
                "allreduce_ms_total": sum(e.get("reduce_ms", 0.0) for e in r["levels"]),
                "k1_ms_total": sum(e["k1_ms"] for e in r["levels"]),
                "hist_bytes_total": sum(e["bytes"] for e in r["levels"]),
                "levels": len(r["levels"])}

    def cv_diff(got):
        return {fam: max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(v))))
                         for k, v in plain["cv"].items() if k[0] == fam and k in got)
                for fam in {k[0] for k in plain["cv"]}}

    ring_err = float(np.max(np.abs(b[0]["corr"] - plain["corr"]))) \
        if b[0]["corr"] is not None and plain["corr"] is not None else None
    out = {"plain": {k: plain[k] for k in ("seconds", "launches", "winner")},
           "nccl": {"seconds": a["seconds"], "ready_s": a["ready_s"],
                    "launches": a["launches"], "collectives": a["collectives"],
                    "cv_diff": cv_diff(a["cv"]), "winner": a["winner"],
                    "deepest_rf_level": deepest(a), "device_mesh": a["device_mesh"],
                    "token": a["token"]},
           "gloo": [{"rank": r["rank"], "seconds": r["seconds"], "ready_s": r["ready_s"],
                     "launches": r["launches"], "collectives": r["collectives"],
                     "cv_diff": cv_diff(r["cv"]), "winner": r["winner"],
                     "deepest_rf_level": deepest(r), "device": r["device"],
                     "token": r["token"]} for r in b],
           "ring_corr_max_err": ring_err,
           "corr_width": None if plain["corr"] is None else int(plain["corr"].shape[0]),
           "rows": CLI_TRAIN_ROWS, "winner": plain["winner"],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "mesh", **out})

    check(plain["failed"] == [] and a["failed"] == [] and all(r["failed"] == [] for r in b),
          "no family failed")
    _mesh_cv_rules(a["cv"], plain["cv"], "(a) one NCCL rank")
    check(a["winner"] == plain["winner"], "(a) the unmeshed winner")
    nccl = a["collectives"]
    check(set(be for by in nccl.values() for be in by) == {"nccl"},
          f"(a) every collective is NCCL's: {nccl}")
    check(sum(c["calls"] for by in nccl.values() for c in by.values()) > 0,
          "(a) NCCL collectives counted")
    check(a["token"] == (("data", "model"), (1, 1), 1, 1, "nccl"), f"(a) token {a['token']}")
    for r in b:
        for k in ("hist_level", "split_scan", "row_select_lanes", "encode_slots"):
            check(r["launches"][k] >= 1, f"(b) rank {r['rank']} launched {k}")
        check(r["digest"] == b[0]["digest"] and r["cv"] == b[0]["cv"]
              and r["kept"] == b[0]["kept"], "(b) the ranks' models bitwise equal")
        check(r["backend"] == "gloo" and r["token"][1] == (2, 1), f"(b) mesh {r['token']}")
    _mesh_cv_rules(b[0]["cv"], plain["cv"], "(b) two gloo ranks")
    check(b[0]["winner"] == plain["winner"], "(b) the unmeshed winner")
    check(b[0]["kept"] == plain["kept"], "(b) the checker keeps the unmeshed slots")
    check(ring_err is not None and plain["corr"].shape[0] > 512 and ring_err <= 1e-5,
          f"(b) ring correlation within 1e-5 of the one-card product ({ring_err})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(1, os.path.join(here, "tests"))  # torch_encode_cases, data
    os.chdir(here)
    if sys.argv[1:2] == ["--deploy-child"]:
        return _deploy_child(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-child"]:
        return _mesh_child(sys.argv[2:])
    if sys.argv[1:2] == ["--phase"]:
        # one self-contained phase alone (its lines, no summary): deploy,
        # cli, registry, static, mesh
        alone = {"deploy": phase_deploy, "cli": phase_cli,
                 "registry": phase_registry, "static": phase_static,
                 "mesh": phase_mesh}
        if sys.argv[2:] not in [[k] for k in alone]:
            print(f"chip_smoke: --phase takes one of {sorted(alone)}", file=sys.stderr)
            return 2
        from transmogrifai_tpu_torch.perf.kernels import encode as KE

        print(gpu_line(), flush=True)
        alone[sys.argv[2]](torch, KE, torch.device("cuda", 0))
        return 0
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
    # the card plan's device state goes with it (plans of one fingerprint
    # share theirs: phase 22 sizes the wide model's alone)
    del plan

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

    # 16. the reference's example apps
    ex = phase_examples(torch, KE, dev)

    # 17. the DSL's features over phase 10's table at full width
    dsl = phase_dsl(torch, KE, dev, raw)

    # 18. typed maps and the raw feature filter
    maps = phase_maps(torch, KE, dev)

    # 19. the text stack
    txt = phase_text(torch, KE, dev)

    # 20. workflow-level CV, ModelInsights and LOCO
    wcv = phase_workflow_cv(torch, KE, dev)

    # 21. Spark-free scoring, streaming, the continual loop, resume
    stream = phase_streaming(torch, KE, dev)

    # 22. the fleet: tenants of every precision class behind one batcher
    fleet = phase_fleet(torch, KE, dev)

    # 23. the telemetry layer: traced serving, per-tenant cost, a profiler
    # capture, a traced train and refit, the runner's stage metrics
    obs = phase_obs(torch, KE, dev)

    # 24. out of core: the chunked store, chunked epochs, resume, score_dataset
    ooc = phase_ooc(torch, KE, dev)

    # 25. the deploy artifact store: a replica booted with no nvcc
    deploy = phase_deploy(torch, KE, dev)

    # 26. the operator CLI and the kernel autotuner
    cli = phase_cli(torch, KE, dev)

    # 27. the registry sweep's cases with a device half, card against CPU
    reg = phase_registry(torch, KE, dev)

    # 28. static analysis: zero cost on the card, the static cost beside the
    # card's, the strict gate, the CLI and the corpus captured on the card
    static = phase_static(torch, KE, dev)

    # 29. data-parallel training over a torch.distributed mesh: one NCCL
    # rank and two gloo ranks sharing the card
    mesh = phase_mesh(torch, KE, dev)

    def mesh_launches(key):
        return {"nccl": mesh["nccl"]["launches"][key],
                "gloo": [r["launches"][key] for r in mesh["gloo"]]}

    # 30. summary
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
        entry["launches_streaming_refit"] = stream["continual"]["refit"]["launches"][kname]
        entry["launches_resumed_sweep"] = stream["resume"]["launches"][kname]
        entry["launches_obs"] = obs["launches"][kname]
        entry["launches_ooc"] = ooc["launches"][kname]
        entry["launches_cli_tuned_train"] = cli["train"]["launches"][kname]
        entry["launches_registry"] = reg["launches"][kname]
        entry["launches_static"] = static["launches_static"][kname]
        entry["launches_mesh"] = mesh_launches(kname)
        entry["autotune"] = _autotune_line(cli, _FAMILY_OF[kname])
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
            "launches_examples": {k: ex[k]["launches"]["encode_slots"]
                                  for k in ("titanic", "iris", "boston")},
            "launches_training_dsl": dsl["launches"]["encode_slots"],
            "launches_serving_dsl": dsl["serving"]["launches"]["encode_slots"],
            "training_dsl": dsl["encode_at_rows"],
            "launches_training_maps": maps["launches"]["encode_slots"],
            "launches_serving_maps": maps["serving"]["launches"]["encode_slots"],
            "training_maps": maps["encode_at_rows"],
            "launches_text_reviews": txt["text_reviews"]["launches"]["encode_slots"],
            "launches_training_text": txt["wide"]["launches"]["encode_slots"],
            "launches_serving_text": txt["wide"]["serving"]["launches"]["encode_slots"],
            "slots_serving_text": txt["wide"]["serving"]["slots_per_batch"],
            **({"launches_workflow_cv": wcv["launches"]["encode_slots"],
                "launches_workflow_cv_parity": wcv["parity"]["launches"]["encode_slots"],
                "workflow_cv_fold_transform": wcv["fold_transform"]}
               if kname == "bucketize_right_encode" else
               {"launches_workflow_cv": wcv["launches"]["encode_slots"]}),
            "launches_streaming": stream["parity"]["launches"]["encode_slots"],
            "launches_fleet": fleet["load"]["launches"],
            "launches_streaming_refit": stream["continual"]["refit"]["encode_launches"],
            "launches_obs": obs["launches"]["encode_slots"],
            "launches_ooc": ooc["launches"]["encode_slots"],
            "launches_deploy": deploy["boot"]["launches"]["encode_slots"],
            "launches_cli_tuned_train": cli["train"]["launches"]["encode_slots"],
            "launches_registry": reg["launches"]["encode_slots"],
            "launches_static": static["launches_static"]["encode_slots"],
            "launches_mesh": mesh_launches("encode_slots"),
            "autotune": _autotune_line(cli, "encode"),
            "ooc_chunk_tile": ooc["chunk_tile"],
            **{f"fused_{k}": fused[k] for k in ("ms", "device_ms", "plain_ms",
                                                 "bound_ms", "slots", "columns")}})
    t = timings["bucketize_left_encode"]
    kernels.append({
        "name": "bucketize_left_encode", "route": "cuda",
        "source": "transmogrifai_tpu_torch/perf/kernels/csrc/encode.cu",
        "replaces": "transmogrifai_tpu/ops/scalers.py:115 (NumericBucketizer."
                    "device_transform: XLA, no pallas_call; a slot kind of the "
                    "kernel of encode.py:76 and :105)",
        "launches": dsl["serving"]["left_closed"]["launches"],
        "slots_per_launch": DSL_LEFT_SLOTS,
        "launches_training_dsl": dsl["left_closed"]["launches"],
        "launches_obs": obs["launches"]["left_closed"],
        "launches_registry": reg["launches"]["left_closed"],
        "launches_static": static["launches_static"]["left_closed"],
        "launches_mesh": mesh_launches("left_closed"),
        "max_abs_err": t["max_abs_err"], "parity": "bitwise",
        "parity_cases": t["parity_cases"],
        "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
        "library": t["library"], "shape": t["shape"],
        "timing": "ms/device_ms/plain_ms/bound_ms/library_ms: one left-closed slot "
                  "at the serving batch; slots8: 8 slots at the dsl phase's rows; "
                  "splits5000: one slot past shared memory",
        "slots8": t["slots8"], "splits5000": t["splits5000"],
        "autotune": _autotune_line(cli, "encode")})
    for k in kernels[:3]:
        k["launches_examples"] = {e: ex[e]["launches"][k["name"]]
                                  for e in ("titanic", "iris", "boston")}
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
