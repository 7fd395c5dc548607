"""DeployBundle — the manifest contract of a packed artifact dir (the port's
counterpart of ``transmogrifai_tpu/deploy/bundle.py``).

One bundle = one fitted model + its serving plan's bucket executables + the
kernel libraries those load on the card:

```
<root>/
  manifest.json                      # this module's schema (BUNDLE_VERSION)
  model/                             # the WorkflowModel (workflow/serde.py)
  objects/<dd>/<key>.bucket.json     # one bucket executable each
  objects/<dd>/<sha256>.so           # one prebuilt kernel library each
```

The manifest is the trust boundary: every integrity and staleness decision
reads it first, and no object byte is parsed or installed before its
recorded sha256 and size verify.  :func:`check_bundle` renders the
decisions as typed TM510 diagnostics — fail-closed: an artifact that cannot
be verified must not be loaded.

Refusal (TM510) vs clean miss:

- **refused** — manifest missing or malformed, a newer (or missing) bundle
  version, no plan or objects section, any object (a library included)
  missing, truncated or hash-mismatched, plan *content* fingerprint drift
  (the model changed since pack), IR-corpus drift when both corpora are
  given, an artifact this package did not pack (no ``torchVersion``), or a
  kernel library built by a CUDA toolkit newer than the CUDA the driver
  under this process runs (a prebuilt library links its toolkit's CUDA
  runtime, which needs a driver at least that new);
- **clean miss** — a different device kind, platform, device count,
  compute capability or kernel token: the artifact is sound but was packed
  for another environment, so hydration warns and the plan builds live.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..checkers.diagnostics import DiagnosticReport, make_diagnostic

#: bump on any manifest schema change; readers refuse NEWER versions (an
#: old process must not half-understand a future manifest) and accept older
BUNDLE_VERSION = 1

MANIFEST_NAME = "manifest.json"
MODEL_DIR = "model"
OBJECTS_DIR = "objects"


def _major_minor(version: Optional[str]) -> Optional[str]:
    if not version:
        return None
    return ".".join(str(version).split(".")[:2])


def _version_int(version: Optional[str]) -> int:
    major, _, minor = str(version).partition(".")
    return int(major) * 1000 + int(minor or 0) * 10


def cuda_driver_version() -> Optional[str]:
    """``major.minor`` of the CUDA the driver under this process runs
    (``cuDriverGetVersion``), or None where there is no CUDA driver."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        version = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(version)) != 0:
            return None
    except (OSError, AttributeError):
        return None
    return f"{version.value // 1000}.{version.value % 1000 // 10}"


def _environment_device(device=None):
    """The device provenance describes: the one an entry point given
    ``device`` runs on, or the host where that is no card.  Describing an
    environment runs nothing on it."""
    import torch

    from ..perf.kernels.dispatch import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError:
        return torch.device("cpu")


def environment_provenance(device=None) -> Dict[str, Any]:
    """The environment facts an artifact's validity depends on, for
    ``device`` (the plan's; see :func:`_environment_device` for the
    default): the torch version, the CUDA versions (``toolkit``: the nvcc
    that builds this process's kernels, None without one; ``torch``: the
    CUDA torch was built with; ``driver``: the CUDA the driver runs), the
    platform (``gpu`` / ``cpu``), the device's kind, the device count, the
    compute capability and the kernel token
    (``perf/kernels/dispatch.py::cache_token``)."""
    import torch

    from ..perf.kernels.dispatch import cache_token, toolkit_version

    dev = _environment_device(device)
    on_card = dev.type == "cuda"
    cap = torch.cuda.get_device_capability(dev) if on_card else None
    return {
        "torchVersion": torch.__version__,
        "cudaVersion": {"toolkit": toolkit_version() if on_card else None,
                        "torch": _major_minor(torch.version.cuda),
                        "driver": cuda_driver_version()},
        "platform": "gpu" if on_card else "cpu",
        "deviceKind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "deviceCount": torch.cuda.device_count() if on_card else 1,
        "computeCapability": f"{cap[0]}.{cap[1]}" if cap else None,
        "kernelToken": cache_token(),
    }


def ir_corpus_fingerprints(goldens_dir: Optional[str] = None
                           ) -> Optional[Dict[str, Any]]:
    """The live IR golden corpus' content fingerprints, or None when no
    corpus index is readable — always None until ``checkers/irsnap.py`` is
    ported (the port has no IR corpus yet); :func:`check_bundle` compares a
    corpus whenever one is given."""
    del goldens_dir
    return None


@dataclass
class DeployBundle:
    """A loaded (not yet verified) artifact dir: root path + manifest."""

    root: str
    manifest: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, root: str) -> "DeployBundle":
        """Read the manifest.  Raises ``FileNotFoundError`` / ``ValueError``
        on a missing or malformed manifest — callers that must not crash
        (hydration) catch and refuse; the gate treats it as fatal."""
        path = os.path.join(root, MANIFEST_NAME)
        with open(path) as fh:
            manifest = json.load(fh)
        if not isinstance(manifest, dict):
            raise ValueError(f"{path}: manifest is not a JSON object")
        return cls(root=root, manifest=manifest)

    @property
    def model_path(self) -> str:
        return os.path.join(self.root,
                            self.manifest.get("model", {}).get("path", MODEL_DIR))

    @property
    def plan(self) -> Dict[str, Any]:
        return self.manifest.get("plan", {})

    @property
    def environment(self) -> Dict[str, Any]:
        return self.manifest.get("environment", {})

    def object_path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def load_model(self):
        """The bundled WorkflowModel (``cli deploy boot``): a checkpoint
        either package saved loads here."""
        from ..workflow.workflow import WorkflowModel

        return WorkflowModel.load(self.model_path)


def _sha256_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


def check_bundle(bundle: DeployBundle, *,
                 content_fingerprint: Optional[str] = None,
                 live_corpus: Optional[Dict[str, Any]] = None,
                 device=None) -> Tuple[DiagnosticReport, List[str]]:
    """Verify a bundle: (TM510 refusal report, environment-drift warnings).

    Error-severity findings mean the artifact must be REFUSED (fail-closed);
    the drift list carries clean-miss explanations that warrant a warning
    and a live build, not a refusal.

    - structural: bundle version, plan and objects sections, object files;
    - integrity: every object's sha256 + size against the manifest, kernel
      libraries included;
    - provenance: ``torchVersion`` present (refusal: another package's
      artifact), each kernel library's CUDA toolkit against the CUDA the
      driver runs (refusal when the toolkit is newer; skipped without a
      driver, where no library is loaded), and the device kind, platform, device count,
      compute capability and kernel token against ``device``'s (drift);
    - staleness: ``content_fingerprint`` (the live plan's) against the
      manifest's, and ``live_corpus`` against the corpus recorded at pack.
    """
    report = DiagnosticReport()
    drift: List[str] = []
    loc = os.path.join(bundle.root, MANIFEST_NAME)

    def refuse(message: str) -> None:
        report.diagnostics.append(make_diagnostic("TM510", message, location=loc))

    version = bundle.manifest.get("bundleVersion")
    if not isinstance(version, int) or version > BUNDLE_VERSION:
        refuse(f"bundle version {version!r} is newer than this reader's "
               f"{BUNDLE_VERSION} (or missing); refusing to interpret it")
        return report, drift

    plan = bundle.plan
    objects = plan.get("objects", {})
    if not plan or not objects:
        refuse("manifest has no plan/objects section — an empty artifact "
               "cannot be verified, and an unverifiable artifact is refused")
        return report, drift
    libraries = plan.get("libraries", {}) or {}

    # integrity first: no payload byte is parsed or installed before its
    # recorded hash verifies
    for what, table in (("bucket", objects), ("library", libraries)):
        for key, meta in sorted(table.items()):
            rel = meta.get("file", "") if isinstance(meta, dict) else ""
            path = bundle.object_path(rel)
            label = f"object for bucket {key}" if what == "bucket" \
                else f"library object {key}"
            if not rel or not os.path.isfile(path):
                refuse(f"{label} missing: {rel}")
                continue
            digest, size = _sha256_file(path)
            if size != meta.get("size") or digest != meta.get("sha256"):
                refuse(f"{label} fails integrity: {rel} is "
                       f"{size}B/sha256:{digest[:12]}…, manifest recorded "
                       f"{meta.get('size')}B/sha256:"
                       f"{str(meta.get('sha256'))[:12]}…")

    env = bundle.environment
    here = environment_provenance(device)
    if not env.get("torchVersion"):
        refuse("artifact has no torchVersion: it was not packed by "
               "transmogrifai_tpu_torch, so its executables are another "
               "runtime's payload and are never loaded here")
    driver = cuda_driver_version()
    if driver is not None:
        for name, meta in sorted(libraries.items()):
            built = _major_minor(meta.get("cudaToolkit")) if isinstance(meta, dict) else None
            try:
                newer = _version_int(built) > _version_int(driver)
            except ValueError:
                newer = True
            if newer:
                refuse(f"kernel library {name} was built by CUDA toolkit "
                       f"{built!r}; the driver under this process runs CUDA "
                       f"{driver} — the library carries its toolkit's CUDA "
                       "runtime, which needs a driver at least that new, so "
                       "it is never loaded here")
    for key, label in (("deviceKind", "device kind"), ("platform", "platform"),
                       ("deviceCount", "device count"),
                       ("computeCapability", "compute capability"),
                       ("kernelToken", "kernel token")):
        if env.get(key) != here[key]:
            drift.append(f"{label} drift: packed under {env.get(key)!r}, "
                         f"live is {here[key]!r} — executable keys differ, "
                         "hydration misses back to a live build")

    if content_fingerprint is not None \
            and plan.get("contentFingerprint") != content_fingerprint:
        refuse(f"plan content fingerprint mismatch: manifest recorded "
               f"{str(plan.get('contentFingerprint'))[:16]}…, the live "
               f"model's is {content_fingerprint[:16]}… — the model "
               "changed since pack; re-pack the bundle")

    packed_corpus = bundle.manifest.get("irCorpus")
    if live_corpus is not None and packed_corpus is not None:
        packed_entries = packed_corpus.get("entries", {})
        live_entries = live_corpus.get("entries", {})
        changed = sorted(key for key, fp in packed_entries.items()
                         if key in live_entries and live_entries[key] != fp)
        if changed:
            refuse("IR-corpus fingerprint drift since pack time: "
                   f"{', '.join(changed[:4])}"
                   + (f" (+{len(changed) - 4} more)" if len(changed) > 4 else "")
                   + " — the program surface changed under the artifact")

    return report, drift
