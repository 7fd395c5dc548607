"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the wide pipeline's training from raw columns (its whole-table transform
plan and the SanityChecker) on the card against the CPU.

Marked ``cuda``: each test skips where there is no card.  The machine with
the card has no JAX, so this file imports torch and the port only; run it
there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.perf.kernels import encode as TKE
from torch_encode_cases import fixture_inputs, slot_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "serving_wide")

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _codes(n: int, width: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(-3, width + 7, n).astype(np.int32)
    edge = np.array([-1, width, width + 5, 0], np.int32)[:n]
    codes[:len(edge)] = edge
    return codes


def _values(n: int, splits: np.ndarray, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).normal(size=n) * 1.5).astype(np.float32)
    x[::7] = np.nan
    x[1], x[2] = np.inf, -np.inf
    finite = splits[np.isfinite(splits)]
    x[3:3 + len(finite)] = finite
    return x


@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
@pytest.mark.parametrize("width", [1, 22, 300])
def test_onehot_kernel_bitwise_and_counted(n, width):
    c = torch.from_numpy(_codes(n, width, seed=n)).cuda()
    before = TKE.onehot_launches
    got = TKE.onehot_codes(c, width)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.onehot_codes_torch(c, width))
    assert TKE.onehot_launches == before + 1


@pytest.mark.parametrize("splits", [[-np.inf, -0.5, 0.1, 0.9, np.inf],
                                    [-1.0, 0.0, 0.5, 2.0]])
@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("track_invalid", [True, False])
def test_bucketize_kernel_bitwise_and_counted(splits, track_nulls, track_invalid):
    s_np = np.asarray(splits, np.float32)
    x = torch.from_numpy(_values(1024, s_np, seed=5)).cuda()
    s = torch.from_numpy(s_np).cuda()
    before = TKE.bucketize_launches
    got = TKE.bucketize_right_encode(x, s, track_nulls, track_invalid)
    torch.cuda.synchronize()
    assert torch.equal(got, TKE.bucketize_right_encode_torch(
        x, s, track_nulls, track_invalid))
    assert TKE.bucketize_launches == before + 1


# -- the fused encode kernel: every slot of a table in one launch --------------

@pytest.mark.parametrize("n", [1, 37, 1024, 1009])
@pytest.mark.parametrize("n_slots", [12, 40])
def test_encode_slots_kernel_bitwise_one_launch(n, n_slots):
    specs, inputs = slot_case(n, n, "cuda", n_slots)
    table = TKE.plan_slots(specs)
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + 1
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


@pytest.mark.parametrize("n_slots", [64, 70, 129])
def test_encode_slots_chunks_counted_per_launch(n_slots):
    specs, inputs = slot_case(300, 7, "cuda", n_slots)
    table = TKE.plan_slots(specs)
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + len(table.chunks)
    assert len(table.chunks) == -(-n_slots // TKE.MAX_SLOTS)
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


@pytest.mark.parametrize("pad, offset", [(0, 0), (4, 0), (3, 0), (4, 1), (8, 2)],
                         ids=["dense", "aligned_stride", "odd_stride",
                              "misaligned_base", "offset_2"])
def test_encode_slots_into_strided_destination(pad, offset):
    """An output that is a view into a wider buffer: every column of the
    view is written, nothing around it; misaligned bases and odd strides
    take the scalar stores."""
    specs, inputs = slot_case(129, 11, "cuda", 70)
    table = TKE.plan_slots(specs)
    w = table.width
    buf = torch.full((129, offset + w + pad), 7.0, device="cuda")
    TKE.encode_slots(inputs, table, buf[:, offset:offset + w])
    torch.cuda.synchronize()
    assert torch.equal(buf[:, offset:offset + w], TKE.encode_slots_torch(inputs, table))
    assert bool((buf[:, :offset] == 7.0).all())
    assert bool((buf[:, offset + w:] == 7.0).all())


def test_encode_slots_fixture_table_bitwise():
    """The serving fixture's whole table (32 one-hot and 8 bucketize slots)
    at 1024, 37 and a prime row count, into the plan's padded buffer."""
    from transmogrifai_tpu_torch import WorkflowModel

    table = WorkflowModel.load(FIXTURE).serving_plan(device="cpu")._encode_table
    assert len(table) == 40 and table.width == 730
    for n in (1024, 37, 997):
        inputs = fixture_inputs(table, n, n, "cuda")
        buf = torch.empty((n, 732), device="cuda")[:, :730]
        before = TKE.encode_slots_launches
        TKE.encode_slots(inputs, table, buf)
        torch.cuda.synchronize()
        assert TKE.encode_slots_launches == before + 1
        assert torch.equal(buf, TKE.encode_slots_torch(inputs, table))


def _records(schema: dict, n: int, rng) -> list:
    """Requests from the fixture's schema with missing values, unseen levels
    and absent fields."""
    out = []
    for _ in range(n):
        r = {}
        for f in schema["features"]:
            u = rng.random()
            if f.get("response") or u < 0.02:
                continue
            if u < 0.1:
                r[f["name"]] = None
            elif f["type"] == "Real":
                r[f["name"]] = float(rng.normal())
            elif f["type"] == "Binary":
                r[f["name"]] = bool(rng.random() < 0.3)
            else:
                r[f["name"]] = (f"unseen{int(rng.integers(1000))}" if u < 0.15
                                else str(rng.choice(f["levels"])))
        out.append(r)
    return out


def test_serving_plan_encodes_a_batch_in_one_launch():
    """The card plan: one encode launch and one copy per operand dtype a
    batch, records equal to the CPU plan's."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    model = WorkflowModel.load(FIXTURE)
    plan, cpu_plan = model.serving_plan(), model.serving_plan(device="cpu")
    rng = np.random.default_rng(3)
    for n in (1024, 37):
        recs = _records(schema, n, rng)
        TKE.reset_launch_counts()
        copies = plan.metrics()["h2d_copies"]
        got = plan.score(recs)
        assert TKE.launch_counts() == {"onehot_codes": 0, "bucketize_right_encode": 0,
                                       "encode_slots": 1, "encode_slots.slots": 40}
        assert plan.metrics()["h2d_copies"] == copies + 2
        assert got == cpu_plan.score(recs)


def test_server_on_the_card_fails_an_oom_batch_not_to_the_cpu():
    """An out-of-memory error at "device" that survives the retries and
    splits fails every request of its batch; nothing is served by the host
    path, and the card plan has none."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.serve import FaultHarness, ScoringServer

    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    recs = _records(schema, 16, np.random.default_rng(5))
    model = WorkflowModel.load(FIXTURE)
    oom = FaultHarness().fail_when("device", lambda ctx: True,
                                   lambda: torch.OutOfMemoryError("injected"))
    with ScoringServer(model, max_batch=16, max_wait_ms=60_000, warm=False,
                       resilience={"seed": 0, "backoff_base_s": 1e-3}) as server:
        with oom:
            errs = [f.exception(timeout=60) for f in [server.submit(r) for r in recs]]
        rows = [f.result(timeout=60) for f in [server.submit(r) for r in recs]]
        res, plan = server.resilience.metrics(), server.plan.metrics()
        with pytest.raises(RuntimeError, match="no host path"):
            server.plan.score_host(recs)
    assert all(isinstance(e, torch.OutOfMemoryError) for e in errs)
    assert (res["device_failures"], res["fallback_batches"], res["fallback_records"]) \
        == (1, 0, 0)
    assert plan["host_scored_records"] == 0
    assert rows == model.serving_plan(device="cpu").score(recs)


# -- tree kernels (K1 histogram, K2 split scan, K3 routing) ---------------------

from transmogrifai_tpu_torch.perf.kernels import histogram as TH  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import routing as TR  # noqa: E402
from transmogrifai_tpu_torch.perf.kernels import splitscan as TS  # noqa: E402


def _hist_case(L, n, d, nn, n_bins, two_k, int_exact, seed):
    rng = np.random.default_rng(seed)
    local = rng.integers(-2, nn + 1, (L, n)).astype(np.int32)
    if int_exact:
        gh = rng.integers(-9, 10, (L, two_k, n)).astype(np.int8)
        gh[:, :, ::5] = 0                      # zero-weight rows
    else:
        gh = rng.normal(size=(L, two_k, n)).astype(np.float32)
    binned = rng.integers(0, n_bins + 1, (n, d)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (local, gh, binned)]


# several node tiles (nn 16, 32), several row slices merged with global
# atomics (few lanes and nodes), several lanes per CTA (nn 1), n_bins 256,
# two_k 4, feature tiles that leave threads idle (d 33, 65, 200), row counts
# that are no multiple of any block (primes)
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 4, 8, 2), (150, 20011, 128, 16, 32, 2), (1, 5, 1, 1, 2, 2),
    (4, 70001, 33, 2, 32, 4), (2, 3000, 65, 32, 16, 2),
    (3, 100003, 128, 16, 32, 2), (12, 65537, 128, 1, 32, 2),
    (2, 30011, 128, 4, 256, 2), (5, 40009, 200, 3, 255, 2)])
def test_hist_int_kernel_bitwise_and_counted(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, True, seed=n)
    before = TH.launches
    got = TH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


# the GBT levels (3 lanes x 1-2 nodes: every lane and node in one CTA, many
# slices summed in order), a tiled many-lane level (150 lanes x 16 nodes),
# ragged d (no 16-byte code copies), two_k 4 and n_bins 255
@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 641, 7, 2, 32, 2), (3, 200003, 128, 1, 32, 2), (12, 50000, 40, 8, 32, 2),
    (3, 262147, 128, 2, 32, 2), (150, 20011, 128, 16, 32, 2),
    (3, 30011, 33, 2, 32, 2), (2, 20011, 64, 2, 255, 4)])
def test_hist_f32_kernel_within_tolerance_and_repeatable(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, False, seed=n)
    a = TH.hist_level(local, gh, binned, nn, n_bins)
    b = TH.hist_level(local, gh, binned, nn, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins)
    tol = TH.f32_tolerance(TH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))
    assert bool(((a - ref).abs() <= tol).all())


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("L, nn, d, n_bins", [(3, 4, 6, 8), (150, 32, 128, 32),
                                              (2, 1, 1, 2)])
def test_split_scan_kernel_bitwise_on_integer_hists(K, L, nn, d, n_bins):
    rng = np.random.default_rng(L * nn + K)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    hg[0, 0] = 0.0
    hh[0, 0] = 0.0                              # an empty node
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = np.ones((L, d), np.float32)
    mask[-1, 0] = 0.0
    args = [torch.from_numpy(a).cuda() for a in (hg, hh, G, H, mask)]
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        before = TS.launches
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        assert TS.launches == before + 1
        ref = TS.split_scan_torch(*args, n_bins, *params)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("params", [(1.0, 0.0, 0.0, 1.0), (1.0, 0.5, 0.1, 1.0)])
def test_split_scan_kernel_on_float_hists_within_tolerance(params):
    L, nn, d, n_bins, n = 3, 4, 128, 32, 200003
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, 2, False, seed=5)
    gh[:, 1] = gh[:, 1].abs()                   # hessians are not negative
    hist = TH.hist_level(local, gh, binned, nn, n_bins).reshape(
        L, nn, 2, n_bins + 1, d).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, d), device="cuda")
    mask[-1, 3] = 0.0
    args = (hg, hh, G, H, mask, n_bins, *params)
    got = TS.split_scan(*args)
    again = TS.split_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    agree = TS.float_agreement(got, *args)
    assert agree["ok"], agree


@pytest.mark.parametrize("L, n, d", [(1, 37, 5), (150, 4099, 128), (3, 100003, 7)])
def test_row_select_kernel_bitwise_and_counted(L, n, d):
    rng = np.random.default_rng(n)
    binned = torch.from_numpy(rng.integers(0, 33, (n, d)).astype(np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(-3, d + 3, (L, n)).astype(np.int32)).cuda()
    before = TR.launches
    got = TR.row_select_lanes(binned, idx)
    torch.cuda.synchronize()
    assert TR.launches == before + 1
    assert torch.equal(got, TR.row_select_lanes_torch(binned, idx))


def _route_plan(path, L, n, d):
    """The plan of ``path`` at this shape, whichever routing.plan picks."""
    p = TR.plan(L, n, d)
    if p.path == path:
        return p
    if path == "direct":
        return TR.RoutePlan("direct", TR.THREADS, 0, TR.THREADS,
                            -(-n // TR.THREADS), 0)
    stride = d | 1
    rows = 64 if 64 * stride * 4 <= 200 * 1024 else 32
    return TR.RoutePlan("tile", rows, stride, TR.THREADS, -(-n // rows),
                        rows * stride * 4)


# both paths on the same inputs: ragged rows (no multiple of 32, 64 or 256),
# d 5 / 128 / 866, negative and out-of-range idx, and every row of a lane
# selecting one feature (the shared-memory bank-conflict case of the tile path)
@pytest.mark.parametrize("path", ["tile", "direct"])
@pytest.mark.parametrize("L, n, d", [(150, 4099, 128), (3, 100003, 128),
                                     (50, 65, 5), (7, 1001, 866), (1, 37, 128)])
@pytest.mark.parametrize("one_feature", [False, True])
def test_row_select_paths_bitwise(path, L, n, d, one_feature):
    rng = np.random.default_rng(L * n + d)
    binned = rng.integers(0, 33, (n, d)).astype(np.int32)
    if one_feature:
        idx = np.repeat((np.arange(L) * 7 % d)[:, None], n, axis=1).astype(np.int32)
    else:
        idx = rng.integers(-3, d + 3, (L, n)).astype(np.int32)
        idx[:, :3] = [-1, d, -(2 ** 31)]
    b, i = (torch.from_numpy(a).cuda() for a in (binned, idx))
    p = _route_plan(path, L, n, d)
    before = TR.launches
    got = TR.launch(b, i, p)
    torch.cuda.synchronize()
    assert TR.launches == before + 1
    assert torch.equal(got, TR.row_select_lanes_torch(b, i))


def _scan_case(L, nn, K, d, n_bins, seed, special=False, miss="filled"):
    """Integer-valued histograms with an empty node, a masked feature, a
    fully masked lane, exact ties (feature 1 a copy of feature 0, node 1 of
    node 0) and, where ``special``, NaN and +-inf cells.  ``miss``: the
    missing-value bin "filled", "empty" (+0 or -0 in every feature) or
    empty in every other feature ("half": warps with both kinds)."""
    rng = np.random.default_rng(seed)
    B = n_bins + 1
    hg = rng.integers(-20, 20, (L, nn, K, d, B)).astype(np.float32)
    hh = rng.integers(0, 30, (L, nn, K, d, B)).astype(np.float32)
    hg[0, 0] = 0.0
    hh[0, 0] = 0.0
    if d > 1:
        hg[..., 1, :] = hg[..., 0, :]
        hh[..., 1, :] = hh[..., 0, :]
    if nn > 2:
        hg[:, 2] = hg[:, 1]
        hh[:, 2] = hh[:, 1]
    if miss != "filled":
        step = 2 if miss == "half" else 1
        hg[..., ::step, n_bins] = 0.0
        hh[..., ::step, n_bins] = 0.0
        hg[..., ::3 * step, n_bins] = -0.0
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    if special:
        for v in (np.nan, np.inf, -np.inf):
            at = tuple(rng.integers(0, s, 40) for s in hg.shape)
            hg[at] = v
            hh[tuple(np.roll(a, 1) for a in at)] = v
    mask = np.ones((L, d), np.float32)
    mask[-1, 0] = 0.0
    if L > 2:
        mask[1] = 0.0
    return [torch.from_numpy(a).cuda() for a in (hg, hh, G, H, mask)]


def _same(a, b):
    """Equal, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


# K 1 and 2, B odd (33) and even (34), d wider than a CTA's feature tile
# (1100: feature tiles in turn), NaN and +-inf, ties, a fully masked lane,
# the missing-value bin filled or empty (+-0: the kernel's shortcut)
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n_bins", [32, 33])
@pytest.mark.parametrize("L, nn, d", [(3, 4, 128), (2, 3, 1100), (4, 2, 6)])
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("miss", ["filled", "empty"])
def test_split_scan_cases_bitwise(K, n_bins, L, nn, d, special, miss):
    args = _scan_case(L, nn, K, d, n_bins, seed=L * d + K + n_bins, special=special,
                      miss=miss)
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        before = TS.launches
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        assert TS.launches == before + 1
        ref = TS.split_scan_torch(*args, n_bins, *params)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and _same(g, r)


def _scan_variants(p, K):
    """plan() and the same launch with the histograms read where they lie,
    and with 1-4 threads sharing each feature's candidates."""
    P, FT = p.blocks_per_cta, p.feats
    out = [p, p._replace(staged=False, stride=0,
                         smem=TS._scan_smem(False, P, FT, K, 0, p.groups))]
    for S in (1, 2, 3, 4):
        if P * FT * S <= TS.SCAN_MAX_THREADS:
            out.append(p._replace(groups=S, threads=P * FT * S,
                                  smem=TS._scan_smem(p.staged, P, FT, K, p.stride, S)))
    return out


# every launch shape gives the same bits: staged or not, 1-4 threads a
# feature; K = 4 with 256 bins does not fit shared memory (the plan reads the
# histograms where they lie); K = 3 keeps its running sums in shared memory;
# alpha 0 (the threshold left out) and not
@pytest.mark.parametrize("L, nn, K, d, n_bins", [(3, 4, 1, 128, 32), (2, 3, 2, 1100, 33),
                                                  (2, 2, 4, 16, 255), (2, 2, 3, 40, 32),
                                                  (150, 32, 1, 128, 32)])
@pytest.mark.parametrize("params", [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)])
@pytest.mark.parametrize("miss", ["filled", "empty", "half"])
def test_split_scan_launch_shapes_bitwise(L, nn, K, d, n_bins, params, miss):
    args = _scan_case(L, nn, K, d, n_bins, seed=K * d, special=True, miss=miss)
    ref = TS.split_scan_torch(*args, n_bins, *params)
    for q in _scan_variants(TS.plan(L, nn, K, d, n_bins), K):
        got = TS.launch(*args, n_bins, *params, q)
        torch.cuda.synchronize()
        assert all(g.dtype == r.dtype and _same(g, r) for g, r in zip(got, ref)), q


@pytest.mark.parametrize("L, nn, d", [(3, 4, 128), (2, 3, 1100)])
def test_split_scan_float_hists_repeatable(L, nn, d):
    n_bins, n = 32, 50021
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, 2, False, seed=d)
    gh[:, 1] = gh[:, 1].abs()
    hist = TH.hist_level(local, gh, binned, nn, n_bins).reshape(
        L, nn, 2, n_bins + 1, d).transpose(-1, -2)
    hg, hh = hist[:, :, :1].contiguous(), hist[:, :, 1:].contiguous()
    G = hg[:, :, :, 0, :].sum(-1)
    H = hh[:, :, :, 0, :].sum(-1)
    mask = torch.ones((L, d), device="cuda")
    args = (hg, hh, G, H, mask, n_bins, 1.0, 0.0, 0.0, 1.0)
    got = TS.split_scan(*args)
    again = TS.split_scan(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert TS.float_agreement(got, *args)["ok"]
    # the same bits from every launch shape: one chain of adds per left sum
    for q in _scan_variants(TS.plan(L, nn, 1, d, n_bins), 1):
        other = TS.launch(*args, q)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, other)), q



# -- channel tiles: past the channels one CTA holds (44 on the int8 path, 54
# on the float one at 33 bins) the histogram tiles them; a tile may hold
# fewer than CT, and another plan of the same level gives the same bits

@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 20011, 128, 4, 32, 44), (150, 4099, 128, 16, 32, 200),
    (2, 30011, 40, 2, 32, 134), (1, 65537, 128, 1, 32, 60)])
def test_hist_int_kernel_channel_tiles_bitwise(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, True, seed=n + two_k)
    p = TH.plan(L, n, d, nn, two_k, n_bins, True)
    assert p["chan_tiles"] > 1
    before = TH.launches
    got = TH.hist_level(local, gh, binned, nn, n_bins, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins, int_exact=True)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("L, n, d, nn, n_bins, two_k", [
    (3, 20011, 128, 4, 32, 200), (150, 4099, 128, 16, 32, 60),
    (1, 65537, 33, 1, 32, 134), (3, 30011, 128, 2, 32, 54)])
def test_hist_f32_kernel_channel_tiles_within_tolerance(L, n, d, nn, n_bins, two_k):
    local, gh, binned = _hist_case(L, n, d, nn, n_bins, two_k, False, seed=n + two_k)
    p = TH.plan(L, n, d, nn, two_k, n_bins, False)
    assert p["chan_tiles"] > 1
    a = TH.hist_level(local, gh, binned, nn, n_bins)
    b = TH.hist_level(local, gh, binned, nn, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = TH.hist_level_torch(local, gh, binned, nn, n_bins)
    tol = TH.f32_tolerance(TH.hist_level_torch(local, gh.abs(), binned, nn, n_bins))
    assert bool(((a - ref).abs() <= tol).all())
    # each cell adds its slice's rows in order whatever the channel tiles:
    # a plan with fewer channels a CTA and the same row slices gives the
    # same bits
    q = TH.finish_plan({**{k: p[k] for k in ("G", "NT", "FT", "threads", "R")},
                        "CT": max(1, p["CT"] // 2)}, L, n, d, nn, two_k, n_bins, False)
    q.update({k: p[k] for k in ("slices", "rows_per_slice", "merge")})
    c = TH.launch(local, gh, binned, nn, n_bins, False, q)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


# K2 at K >= 24: the plan reads the histograms where they lie (unstaged)
@pytest.mark.parametrize("K, L, nn, d", [(24, 3, 4, 128), (100, 3, 4, 128),
                                        (30, 150, 16, 16)])
@pytest.mark.parametrize("miss", ["filled", "empty"])
def test_split_scan_unstaged_many_classes_bitwise(K, L, nn, d, miss):
    n_bins = 32
    assert not TS.plan(L, nn, K, d, n_bins).staged
    args = _scan_case(L, nn, K, d, n_bins, seed=K + L, special=False, miss=miss)
    for params in [(1.0, 0.5, 0.1, 1.0), (0.0, 0.0, 0.0, 1.0)]:
        got = TS.split_scan(*args, n_bins, *params)
        torch.cuda.synchronize()
        ref = TS.split_scan_torch(*args, n_bins, *params)
        assert all(g.dtype == r.dtype and _same(g, r) for g, r in zip(got, ref))

# -- a bucketize slot past shared memory: its own launch, splits read from
# global memory by a binary search

@pytest.mark.parametrize("n_splits", [4097, 5000, 12288])
@pytest.mark.parametrize("track_nulls, track_invalid", [(True, True), (False, False)])
def test_bucketize_kernel_past_shared_memory_bitwise(n_splits, track_nulls, track_invalid):
    s_np = np.sort(np.random.default_rng(n_splits).normal(size=n_splits)).astype(np.float32)
    s_np[0], s_np[-1] = -np.inf, np.inf
    x = torch.from_numpy(_values(3001, s_np[:40], seed=n_splits)).cuda()
    x[40:80] = torch.from_numpy(s_np[1000:1040]).cuda()       # on a split
    s = torch.from_numpy(s_np).cuda()
    before = TKE.bucketize_launches
    got = TKE.bucketize_right_encode(x, s, track_nulls, track_invalid)
    torch.cuda.synchronize()
    assert TKE.bucketize_launches == before + 1
    assert torch.equal(got, TKE.bucketize_right_encode_torch(x, s, track_nulls,
                                                             track_invalid))


@pytest.mark.parametrize("where", [0, 3, 6])
def test_encode_slots_with_a_5000_split_slot_bitwise(where):
    """The oversized slot launches alone; the others keep shared memory."""
    specs, inputs = slot_case(1024, 7, "cuda", 6)
    big = np.sort(np.random.default_rng(1).normal(size=5000)).astype(np.float32)
    specs.insert(where, TKE.bucketize_slot(big, True, True))
    inputs.insert(where, torch.from_numpy(_values(1024, big[:30], seed=2)).cuda())
    table = TKE.plan_slots(specs)
    assert (where, where + 1) in table.chunks
    before = TKE.encode_slots_launches
    got = TKE.encode_slots(inputs, table)
    torch.cuda.synchronize()
    assert TKE.encode_slots_launches == before + len(table.chunks)
    assert torch.equal(got, TKE.encode_slots_torch(inputs, table))


# -- K1 int8 past 2**31 // 127 rows: the guard follows the data

def test_hist_int_kernel_past_16_9m_rows_bitwise():
    n = (2 ** 31 - 1) // 127 + 1001
    g = torch.Generator(device="cuda").manual_seed(0)
    binned = torch.randint(0, 33, (n, 3), generator=g, device="cuda", dtype=torch.int32)
    local = torch.randint(-1, 2, (1, n), generator=g, device="cuda", dtype=torch.int32)
    w = torch.randint(0, 2, (n,), generator=g, device="cuda", dtype=torch.int8)
    gh = torch.stack([-w, w])[None].contiguous()
    before = TH.launches
    got = TH.hist_level(local, gh, binned, 2, 32, int_exact=True)
    torch.cuda.synchronize()
    assert TH.launches == before + 1
    assert torch.equal(got, TH.hist_level_torch(local, gh, binned, 2, 32, int_exact=True))


# -- the linear fits on the card against the port on the CPU (TF32 off)

def _linear_data(n=4096, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ rng.normal(size=d)) / np.sqrt(d)))) \
        .astype(np.float32)
    fold = rng.permutation(n) % 3
    tw = np.stack([(fold != f).astype(np.float32) for f in range(3)])
    return x, y, tw, 1.0 - tw


@pytest.mark.parametrize("fam", ["lr", "svc"])
def test_linear_sweeps_on_the_card_equal_the_cpu(fam):
    from transmogrifai_tpu_torch.evaluators.metrics import au_pr
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.models.svm import LinearSVC

    x, y, tw, vw = _linear_data()
    if fam == "lr":
        est, grids = LogisticRegression(), [{"reg_param": r, "elastic_net": e}
                                            for r in (0.001, 0.1) for e in (0.0, 0.5)]
    else:
        est, grids = LinearSVC(), [{"reg_param": r} for r in (0.01, 0.1)]
    card = est.cv_sweep(x, y, tw, vw, grids, au_pr, torch.device("cuda"))
    cpu = est.cv_sweep(x, y, tw, vw, grids, au_pr, torch.device("cpu"))
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    for g in grids:
        a = est.copy().set_params(**g)._fit_arrays(x, y, tw[0], torch.device("cuda"))
        b = est.copy().set_params(**g)._fit_arrays(x, y, tw[0], torch.device("cpu"))
        np.testing.assert_allclose(a.coef, b.coef, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.intercept, b.intercept, rtol=1e-4, atol=1e-4)


# -- the wide pipeline from raw columns: the training plan and the checker -----

RAW_CUT = dict(n_real=6, n_bucketized=3, n_pick=4, n_levels=30, n_binary=2)


def _raw(n: int, device: str):
    """The wide pipeline at a cut, trained on ``device``; (model, checker,
    selector, dataset, vector feature)."""
    import transmogrifai_tpu_torch as T
    from torch_wide_data import make_data, wide_pipeline
    from transmogrifai_tpu_torch.types import feature_type_by_name

    cols, schema = make_data(n, **RAW_CUT)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = wide_pipeline(T, ftypes, schema)
    ds = T.Dataset.from_features(cols, ftypes)
    model = T.Workflow().set_input_dataset(ds).set_result_features(label, pred) \
        .train(device=device)
    return model, chk, sel, ds, chk.inputs[1]


@pytest.mark.parametrize("n", [3000, 20011])
def test_training_plan_vector_on_the_card_equals_the_plain_path(n):
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    model, _, _, ds, vec = _raw(n, "cpu")
    TKE.reset_launch_counts()
    card = transform_dag(ds, [vec], model.fitted, torch.device("cuda"))[vec.name]
    counts = TKE.launch_counts()
    cpu = transform_dag(ds, [vec], model.fitted, torch.device("cpu"))[vec.name]
    assert card.data.shape == cpu.data.shape
    assert card.data.tobytes() == cpu.data.tobytes()
    assert card.meta.to_dict() == cpu.meta.to_dict()
    assert counts["encode_slots"] == 1 and counts["onehot_codes"] == 0


@pytest.mark.parametrize("params", [{}, {"correlation_type": "spearman"},
                                    {"min_correlation": 0.02}])
def test_sanity_checker_on_the_card_equals_the_cpu(params):
    from transmogrifai_tpu_torch import Dataset, FeatureBuilder
    from transmogrifai_tpu_torch.checkers.sanity import SanityChecker
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    model, _, _, ds, vec = _raw(3000, "cpu")
    col = transform_dag(ds, [vec], model.fitted, torch.device("cpu"))[vec.name]
    fits = []
    for dev in ("cuda", "cpu"):
        label = FeatureBuilder.RealNN("label").extract_field().as_response()
        v = FeatureBuilder.OPVector("v").extract_field().as_predictor()
        chk = SanityChecker(**params)
        label.transform_with(chk, v)
        fits.append(chk.fit(Dataset({"label": ds["label"], "v": col}), device=dev))
    card, cpu = (f.summary for f in fits)
    assert fits[0].kept_indices == fits[1].kept_indices
    assert card.dropped == cpu.dropped
    for a, b in zip(cpu.stats, card.stats):
        for k in ("mean", "variance", "min", "max", "corr_label", "cramers_v",
                  "max_rule_confidence", "support"):
            x, y = getattr(a, k), getattr(b, k)
            if x is None:
                assert y is None
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=f"{a.name} {k}")
    np.testing.assert_allclose(card.correlations_feature, cpu.correlations_feature,
                               rtol=0, atol=1e-5)


def test_training_from_raw_columns_on_the_card_equals_the_cpu():
    TKE.reset_launch_counts()
    cm, cchk, csel, _, _ = _raw(3000, "cuda")
    assert TKE.launch_counts()["encode_slots"] == 1
    pm, pchk, psel, _, _ = _raw(3000, "cpu")

    def states(m):
        return sorted((type(t).__name__, [f.name for f in t.inputs],
                       repr(getattr(t, "fills", None)), getattr(t, "vocabs", None),
                       getattr(t, "splits", None))
                      for t in m.fitted.values() if not hasattr(t, "summary"))

    assert states(cm) == states(pm)
    assert cm.fitted[cchk.uid].kept_indices == pm.fitted[pchk.uid].kept_indices
    a, b = cm.fitted[csel.uid], pm.fitted[psel.uid]
    assert a.summary.best_grid == b.summary.best_grid
    for x, y in zip(a.summary.validation_results, b.summary.validation_results):
        np.testing.assert_allclose(x.metric_values, y.metric_values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.model.coef, b.model.coef, rtol=1e-4, atol=1e-5)


# -- the families: text, dates, lists, multi-pick lists, geolocations ------------

FAMILIES = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "training_families")


def _families(n: int, device: str):
    """The families pipeline trained on ``device``: (model, selector,
    checker, dataset, profile)."""
    import transmogrifai_tpu_torch as T
    from torch_families_data import families_pipeline, make_families
    from transmogrifai_tpu_torch.types import feature_type_by_name

    cols, schema = make_families(n, seed=0)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    label, sel, chk, pred = families_pipeline(T, ftypes, schema)
    ds = T.Dataset.from_features(cols, ftypes)
    wf = T.Workflow().set_input_dataset(ds).set_result_features(label, pred)
    return wf.train(device=device), sel, chk, ds, wf.last_train_profile


def test_families_native_library_builds_and_takes_every_hash():
    from torch_families_data import make_families
    from transmogrifai_tpu_torch import native

    assert native.warmup(), native.BUILD_ERROR
    cols, _ = make_families(3000, seed=1)
    native.reset_path_counts()
    block, _ = native.tokenize_hash_count(cols["review"], 512)
    lists = native.hash_count_block(cols["keywords"], 512)
    counts = native.path_counts()
    assert counts["tokenize_hash_count.native"] == 1
    assert counts["hash_count_block.native"] >= 1
    assert not [k for k in counts if k.endswith(".python")], counts
    saved = native._LIB
    try:  # the Python path on the same inputs gives the same bits
        native._LIB = None
        assert native.tokenize_hash_count(cols["review"], 512)[0].tobytes() == block.tobytes()
        assert native.hash_count_block(cols["keywords"], 512).tobytes() == lists.tobytes()
    finally:
        native._LIB = saved


def test_families_training_on_the_card_equals_the_record():
    """At the record's 4096 rows: fitted states and the training vector
    equal the JAX package's record; the pick lists' two slots in one encode
    launch; LR within 1e-4 of the CPU train (the card's float32 sums run in
    another order)."""
    import json

    from torch_families_data import fitted_states, vector_digest
    from transmogrifai_tpu_torch import native
    from transmogrifai_tpu_torch.workflow.fit import transform_dag

    with open(os.path.join(FAMILIES, "states.json")) as fh:
        states = json.load(fh)
    native.reset_path_counts()
    TKE.reset_launch_counts()
    cm, csel, cchk, ds, prof = _families(states["rows"], "cuda")
    launches = TKE.launch_counts()
    assert launches["encode_slots"] == 1 and launches["encode_slots.slots"] == 2
    assert not [k for k in native.path_counts() if k.endswith(".python")]
    assert json.loads(json.dumps(fitted_states(cm))) == states["fitted"]
    vec = cchk.inputs[1]
    card = transform_dag(ds, [vec], cm.fitted, torch.device("cuda"))[vec.name]
    assert vector_digest(card.data) == states["vector"]
    pm, psel, _, _, _ = _families(states["rows"], "cpu")
    a, b = cm.fitted[csel.uid], pm.fitted[psel.uid]
    assert a.summary.best_grid == b.summary.best_grid
    for x, y in zip(a.summary.validation_results, b.summary.validation_results):
        np.testing.assert_allclose(x.metric_values, y.metric_values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.model.coef, b.model.coef, rtol=1e-4, atol=1e-5)


def test_families_serving_plan_on_the_card_equals_the_cpu():
    """The JAX package's saved model on the card: one encode launch (2
    slots) per batch; records equal to the CPU plan's and, within 1e-12,
    to the JAX serving plan's record (another machine's float64 head)."""
    import json

    from transmogrifai_tpu_torch import WorkflowModel

    with open(os.path.join(FAMILIES, "records.json")) as fh:
        rec = json.load(fh)
    model = WorkflowModel.load(FAMILIES)
    plan, cpu_plan = model.serving_plan(), model.serving_plan(device="cpu")
    for b in rec["batches"]:
        TKE.reset_launch_counts()
        got = plan.score(b["records"])
        assert TKE.launch_counts()["encode_slots"] == 1
        assert TKE.launch_counts()["encode_slots.slots"] == 2
        assert got == cpu_plan.score(b["records"])
        name = rec["prediction"]
        dev = max(abs(g[name]["probability_1"] - w[name]["probability_1"])
                  for g, w in zip(got, b["scored"]))
        assert dev <= 1e-12, dev
