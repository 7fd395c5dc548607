"""Why the Iris app's multinomial LR refit on the card differs from the JAX
record: the refit's vector and its Adam trajectory on the card against the
CPU, from the same inputs.

The Iris workflow (``tests/torch_examples_data.py::iris_workflow``: the
indexed label, the transmogrified measurements, the default multiclass
selector) trains on each device in turn, ``models/softmax.py::_softmax_fits``
wrapped to keep the refit's inputs (the one fit with a single weight row).
Then:

1. the refit's vector, labels and weights on the card against the CPU's,
   bitwise;
2. from the CPU's inputs, the weights after 1, 10, 50, 200 (the refit's
   ``max_iter``) and 2000 Adam steps on each device, and the largest
   difference between the devices at each;
3. the weighted gradient's norm after 200 steps (float64, on the host) and
   the 200-step weights' distance from the 2000-step ones: how far the refit
   ends short of its optimum;
4. the CPU's sensitivity: the 200-step fit from the CPU's vector with every
   entry moved by one float32 ulp (``PERTURBATIONS`` random signs), and the
   largest move of the scoring rows' probabilities that this gives;
5. the scoring reader's probabilities (``iris_records(seed=4)``) from each
   device's 200-step weights and from the CPU's perturbed fits, beside the
   JAX record (``fixtures/examples/record.json``);
6. the first step's intercept gradient on each device (it is zero in exact
   arithmetic: the classes are balanced and every probability starts at
   1/3), and the spread of the refit family
   (``tests/torch_examples_data.py::refit_spread``: the largest difference
   in a scoring probability between two fits whose first Adam step put the
   intercepts anywhere on a grid over (-0.3, 0.3) per class);
7. the matmul precision inside ``full_f32``.

Run on the card (the CPU part runs in the same process):

    python3 tools/torch_iris_refit.py --out iris_refit.json

With no card it runs the CPU half alone (``--device cpu``), for a rehearsal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = (1, 10, 50, 200, 2000)
PERTURBATIONS = 8


def _train(E, dev):
    """Train the Iris workflow on ``dev``; returns (model, the refit's
    (x, y_onehot, w, regs, max_iter))."""
    with E.refit_inputs() as kept:
        model = E.iris_workflow(E.records_reader(E.iris_records())).train(device=dev)
    return model, kept[-1]


def _probs(vec: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The model's float64 head: softmax of vec @ coef + intercept."""
    from transmogrifai_tpu_torch.models.base import softmax_probs

    logits = vec.astype(np.float64) @ b[:-1].astype(np.float64) + b[-1].astype(np.float64)
    return softmax_probs(logits)


def _grad64(x, y1, w, reg, b) -> np.ndarray:
    """The refit objective's gradient at ``b`` in float64 on the host."""
    x, y1, w, b = (np.asarray(a, np.float64) for a in (x, y1, w, b))
    z = x @ b
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    g = x.T @ (w[:, None] * (p - y1)) / max(w.sum(), 1e-12)
    pen = np.ones((x.shape[1], 1))
    pen[-1] = 0.0
    return g + reg * pen * b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "iris_refit.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch

    import torch_examples_data as E
    from transmogrifai_tpu_torch.models import softmax as S
    from transmogrifai_tpu_torch.models.base import full_f32

    devices = ["cpu"] if args.device == "cpu" else [args.device, "cpu"]
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_iris_refit: no CUDA device", file=sys.stderr)
        return 1
    out: dict = {"torch": torch.__version__}
    if args.device != "cpu":
        out["device_name"] = torch.cuda.get_device_name(0)
    refits, models = {}, {}
    for dev in devices:
        models[dev], refits[dev] = _train(E, dev)
    base = refits["cpu"]
    x, y1, w, regs, max_iter = base
    out["refit"] = {"rows": int(x.shape[0]), "cols": int(x.shape[1]),
                    "reg": float(regs[0]), "max_iter": max_iter}
    if len(devices) == 2:
        other = refits[devices[0]]
        out["inputs_bitwise_equal"] = {
            k: bool(a.numpy().tobytes() == c.numpy().tobytes())
            for k, a, c in zip(("x", "y_onehot", "w", "regs"), other[:4], base[:4])}
        out["inputs_max_abs_diff"] = float((other[0] - base[0]).abs().max())

    with full_f32():
        out["matmul_precision_in_full_f32"] = {
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "fp32_precision": getattr(torch.backends.cuda.matmul, "fp32_precision", None),
            "float32_matmul_precision": torch.get_float32_matmul_precision()}

    def fit(dev, xx, steps):
        with full_f32():
            return S._softmax_fits(xx.to(dev), y1.to(dev), w.to(dev), regs.to(dev), steps,
                                   True)[0].cpu().numpy()

    traj = {dev: {s: fit(dev, x, s) for s in STEPS} for dev in devices}
    if len(devices) == 2:
        out["device_vs_cpu_max_abs_b"] = {
            str(s): float(np.abs(traj[devices[0]][s] - traj["cpu"][s]).max()) for s in STEPS}
    out["convergence"] = {
        dev: {"grad_norm_at_200": float(np.linalg.norm(_grad64(x, y1, w[0], float(regs[0]),
                                                                traj[dev][200]))),
              "grad_norm_at_2000": float(np.linalg.norm(_grad64(x, y1, w[0], float(regs[0]),
                                                                 traj[dev][2000]))),
              "max_abs_b_200_vs_2000": float(np.abs(traj[dev][200] - traj[dev][2000]).max()),
              "max_abs_b": float(np.abs(traj[dev][200]).max())}
        for dev in devices}

    vec = E.iris_scoring_vector(models["cpu"])
    with open(os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "examples",
                           "record.json")) as fh:
        record = np.asarray(json.load(fh)["iris"]["scores"]["prob"])
    probs = {dev: _probs(vec, traj[dev][200]) for dev in devices}
    out["prob_vs_record_max_abs"] = {dev: float(np.abs(p - record).max())
                                     for dev, p in probs.items()}
    if len(devices) == 2:
        out["prob_device_vs_cpu_max_abs"] = float(np.abs(probs[devices[0]]
                                                         - probs["cpu"]).max())
    out["first_intercept_gradient"] = {}
    for dev in devices:
        with full_f32():
            xd, yd = x.to(dev), y1.to(dev)
            r = w.to(dev).T * (torch.full_like(yd, 1.0 / yd.shape[1]) - yd)
            out["first_intercept_gradient"][dev] = ((xd.T @ r)[-1] / w.sum()).cpu().tolist()
    out["first_intercept_gradient"]["exact"] = (
        (torch.exp(torch.log_softmax(torch.zeros_like(y1), -1)) - y1).double().sum(0)
        / float(w.sum())).tolist()
    out["first_step_intercepts"] = {dev: traj[dev][1][-1].tolist() for dev in devices}
    out["refit_spread"] = E.iris_refit_bound(models["cpu"], base)
    winner = {dev: type(m.selector_model().model).__name__ for dev, m in models.items()}
    out["winners"] = winner

    # one float32 ulp on every entry of the vector (the ones column kept)
    rng = np.random.default_rng(0)
    moves, bmoves = [], []
    for _ in range(PERTURBATIONS):
        xn = x.numpy().copy()
        sign = rng.choice([-1.0, 1.0], size=xn[:, :-1].shape).astype(np.float32)
        xn[:, :-1] = np.nextafter(xn[:, :-1], xn[:, :-1] + sign * np.float32(np.inf))
        b = fit("cpu", torch.from_numpy(xn), 200)
        bmoves.append(float(np.abs(b - traj["cpu"][200]).max()))
        moves.append(float(np.abs(_probs(vec, b) - probs["cpu"]).max()))
    out["cpu_one_ulp"] = {"prob_max_abs_move": moves, "b_max_abs_move": bmoves,
                          "prob_max": max(moves), "b_max": max(bmoves)}
    text = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
