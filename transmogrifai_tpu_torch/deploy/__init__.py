"""deploy/ — content-addressed serving artifacts, so a replica boots
without building a kernel (the port's counterpart of
``transmogrifai_tpu/deploy``).

A fresh replica of the port would build every kernel library with ``nvcc``
before it serves, and an image without the CUDA toolkit could not serve at
all.  This package packs what a warmed serving plan needs on the card into
an artifact dir, and boots a replica from it:

- :class:`~.store.ArtifactStore` — packs a fitted model's checkpoint, one
  executable per row bucket (``serve/plan.py::BucketExecutable``: the
  bucket's staging and landing specs and the kernel libraries it loads,
  serialized as JSON by ``perf.programs.serialize_compiled``) and one
  object per prebuilt kernel library, keyed by plan fingerprint x bucket x
  kernel token (``perf/kernels/dispatch.py::cache_token``).
- :class:`~.bundle.DeployBundle` — the ``manifest.json`` contract: the
  checkpoint, the plan's fingerprints (environment-qualified and
  content-only), each object's sha256 and size, each library's source
  digest and CUDA toolkit, and the environment's provenance (torch and CUDA
  versions, platform, device kind and count, compute capability, kernel
  token).
- **Fail-closed refusal (TM510)** — a stale or tampered artifact (truncated
  bytes, a hash mismatch, content-fingerprint drift, another package's
  artifact, a library built by a CUDA toolkit newer than the driver) is
  refused, never loaded; the plan then builds live.  Environment drift (device kind,
  platform, device count, compute capability, kernel token) is a clean miss
  back to a live build, with a warning.
- Hydration wires through ``ModelRegistry.register(artifact=...)`` and
  ``CompiledScoringPlan.adopt_executable``: a ``FleetServer`` boots its
  tenants from one artifact dir with no ``nvcc`` build, the library load a
  cache hit, and no compile event after ``register``; every hydrate,
  refusal and miss lands a flight-recorder event (obs/flight.py).

CLI: ``python -m transmogrifai_tpu_torch.cli deploy pack|verify|boot``.
CI: ``tools/torch_deploy_gate.py`` verifies a packed artifact dir and
refuses to report green on an empty or unparseable one.
"""

from .bundle import (  # noqa: F401
    BUNDLE_VERSION,
    DeployBundle,
    check_bundle,
    environment_provenance,
)
from .store import (  # noqa: F401
    ArtifactStore,
    artifact_key,
    artifact_store_stats,
    pack_model,
    reset_artifact_store_stats,
)

__all__ = [
    "ArtifactStore",
    "BUNDLE_VERSION",
    "DeployBundle",
    "artifact_key",
    "artifact_store_stats",
    "check_bundle",
    "environment_provenance",
    "pack_model",
    "reset_artifact_store_stats",
]
