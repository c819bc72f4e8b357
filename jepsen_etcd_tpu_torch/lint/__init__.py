"""graftlint: AST-level determinism, columnar-discipline, torch-hygiene,
thread-safety, and telemetry-registry analysis for this repo.

Every correctness bar this port enforces — same-seed golden-hash
bit-identity, verdict equality at every stream chunk size, the
``dict_materializations == 0`` columnar guard — is a *dynamic* check:
a fuzz test has to happen to execute the offending path. graftlint is
the static twin: it proves at parse time that no wall-clock or
unseeded-random call is reachable from a verdict path, that columnar
modules never touch the dict op APIs, that no per-iteration ``torch``
launch, host sync or per-call build hides in a host loop, that cross-thread
state on the stream-feed surface stays behind its lock, and that every
telemetry name in code exists in the canonical registry
(``runner/telemetry.py REGISTRY``) so ``/aggregate`` columns can't
silently go dark.

Usage::

    python -m jepsen_etcd_tpu_torch.lint                 # whole package
    python -m jepsen_etcd_tpu_torch.lint --rule DET      # one family
    python -m jepsen_etcd_tpu_torch.lint --json          # machine output

Suppress a finding in place, with a reason::

    h.ops  # graftlint: ignore[COL001] dict fallback when columns absent

Suppressions without a reason are themselves findings (LINT002), and
suppressions whose rule no longer fires are flagged as orphans
(LINT001), so the ignore inventory can only shrink. Grandfathered
findings live in ``lint/baseline.json`` with a recorded reason each;
stale baseline entries are flagged (LINT004). The rule catalogue is
documented in STATIC_ANALYSIS.md; the TORCH family, the counterpart of
its JAX family, in ``rules/torch_rules.py``.
"""

from .engine import Finding, Report, run_lint, load_baseline
from .policy import Policy

__all__ = ["Finding", "Report", "run_lint", "load_baseline", "Policy"]
