"""Rolling canary hot-reload: swap one replica, prove it, roll the rest.

The single-process registry reload already guarantees a bad push
degrades to "nothing changed" on ONE process.  At fleet scale the risk is
different: a checkpoint that loads fine but answers garbage would take
the whole fleet down at once if every replica swapped together.  The
rolling reload spends one replica to find out first:

1. **Canary**: the least-loaded live replica is parked out of rotation
   (state ``canary``) and told to ``/reload`` the new checkpoint.  A
   corrupt / missing / wrong-geometry checkpoint is refused by the
   replica's own integrity-verified reload — the canary keeps serving the
   old digest, rejoins, and the fleet never changed.
2. **Verify**: the canary's ``/healthz`` must report the digest its
   reload answered with (``variables_digest``), so
   the router never trusts a swap it cannot see.
3. **Shadow**: recently captured live request bodies are replayed to the
   canary (new digest) and to a reference replica (old digest); each
   comparison is journaled as a ``fleet_shadow`` event with the agreement
   fraction.  A canary that errors on shadow traffic — or agrees below
   ``agree_floor`` when one is set — is rolled BACK to the old
   checkpoint and the reload fails with the fleet fully on the old
   digest.  (Agreement below 1.0 is legitimate for a genuinely different
   model, so the floor defaults to 0: the hard gate is "answers every
   request, correct shape"; the agreement number is for the operator and
   for same-model pushes, where it should read 1.0.)
4. **Roll**: the remaining replicas reload one at a time — each swap is
   the replica's own zero-drop atomic reload, so the fleet keeps serving
   throughout — and the canary rejoins rotation.

The outcome (``converged`` / ``failed`` / ``partial``) is journaled as a
``fleet_reload`` event; every phase transition as ``fleet_canary``.
"""

from __future__ import annotations

import http.client
import json
import time

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.serve.fleet import membership as ms
from eegnetreplication_tpu_torch.serve.fleet.router import FleetRouter
from eegnetreplication_tpu_torch.utils.logging import logger

# ReplicaClient raises both for transport failure (BadStatusLine is NOT
# an OSError, unlike RemoteDisconnected) — a reload must journal its
# failed outcome for either, never let one escape run().
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class RollingReload:
    """One rolling canary reload of a fleet to ``checkpoint``.

    ``previous_checkpoint`` is the fleet's currently served checkpoint —
    the rollback target when the shadow compare rejects the canary.
    """

    def __init__(self, router: FleetRouter, checkpoint: str, *,
                 previous_checkpoint: str | None = None,
                 shadow_n: int = 16, agree_floor: float = 0.0,
                 reload_timeout_s: float = 600.0, journal=None):
        self.router = router
        self.membership = router.membership
        self.checkpoint = str(checkpoint)
        self.previous_checkpoint = (str(previous_checkpoint)
                                    if previous_checkpoint else None)
        self.shadow_n = int(shadow_n)
        self.agree_floor = float(agree_floor)
        self.reload_timeout_s = float(reload_timeout_s)
        self._journal = journal if journal is not None \
            else obs_journal.current()

    # -- plumbing ----------------------------------------------------------
    def _phase(self, phase: str, **fields) -> None:
        self._journal.event("fleet_canary", phase=phase, **fields)
        logger.info("Rolling reload: %s %s", phase,
                    {k: v for k, v in fields.items() if k != "error"})

    def _reload_replica(self, replica: ms.Replica) -> tuple[bool, str, str]:
        """POST /reload on one replica; returns (ok, digest_or_error,
        raw_error)."""
        body = json.dumps({"checkpoint": self.checkpoint}).encode()
        try:
            status, data = replica.client.request(
                "POST", "/reload", body=body,
                headers={"Content-Type": "application/json"},
                timeout_s=self.reload_timeout_s)
        except _TRANSPORT_ERRORS as exc:
            return False, "", f"{type(exc).__name__}: {exc}"
        try:
            payload = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            payload = {}
        if status != 200:
            return False, "", str(payload.get("error", f"http {status}"))
        return True, str(payload.get("model_digest", "")), ""

    def _healthz_digest(self, replica: ms.Replica) -> str | None:
        try:
            _, data = replica.client.request("GET", "/healthz",
                                             timeout_s=5.0)
            return json.loads(data.decode()).get("variables_digest")
        except _TRANSPORT_ERRORS + (ValueError, UnicodeDecodeError):
            return None

    @staticmethod
    def _predictions(data: bytes) -> list | None:
        try:
            payload = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            return None
        preds = payload.get("predictions")
        return preds if isinstance(preds, list) else None

    # -- the shadow compare ------------------------------------------------
    def _shadow(self, canary: ms.Replica, reference: ms.Replica) -> dict:
        """Replay captured live bodies to canary + reference; returns
        ``{"n": compared, "errors": canary_errors, "agree": mean}``."""
        samples = self.router.recent_bodies(self.shadow_n)
        compared, errors, agree_sum = 0, 0, 0.0
        for body, content_type in samples:
            try:
                ref_status, ref_data = self.router.dispatch_to(
                    reference, body, content_type)
            except _TRANSPORT_ERRORS:
                continue  # reference hiccup: not the canary's fault
            ref_preds = self._predictions(ref_data)
            if ref_status != 200 or ref_preds is None:
                continue
            try:
                can_status, can_data = self.router.dispatch_to(
                    canary, body, content_type)
            except _TRANSPORT_ERRORS as exc:
                errors += 1
                self._journal.event(
                    "fleet_shadow", replica=canary.replica_id,
                    reference=reference.replica_id, n_trials=len(ref_preds),
                    agree=0.0, error=f"{type(exc).__name__}: {exc}")
                continue
            can_preds = self._predictions(can_data)
            if can_status != 200 or can_preds is None \
                    or len(can_preds) != len(ref_preds):
                errors += 1
                self._journal.event(
                    "fleet_shadow", replica=canary.replica_id,
                    reference=reference.replica_id, n_trials=len(ref_preds),
                    agree=0.0, error=f"canary http {can_status} / "
                                     f"malformed predictions")
                continue
            matches = sum(1 for a, b in zip(can_preds, ref_preds) if a == b)
            frac = matches / max(len(ref_preds), 1)
            compared += 1
            agree_sum += frac
            self._journal.event(
                "fleet_shadow", replica=canary.replica_id,
                reference=reference.replica_id, n_trials=len(ref_preds),
                agree=round(frac, 4))
        return {"n": compared, "errors": errors,
                "agree": round(agree_sum / compared, 4) if compared
                else None}

    # -- the rolling reload ------------------------------------------------
    def run(self) -> dict:
        t0 = time.perf_counter()
        live = self.membership.dispatchable()
        if not live:
            return self._finish("failed", stage="no_live_replicas",
                                wall_s=time.perf_counter() - t0)
        old_digest = live[0].digest
        canary = min(live, key=lambda r: r.load)
        self._phase("start", replica=canary.replica_id,
                    checkpoint=self.checkpoint, old_digest=old_digest,
                    fleet_size=len(live))
        # Park the canary: shadow traffic only, until it proves itself.
        self.membership.set_state(canary, ms.CANARY, "canary_elected")
        try:
            ok, new_digest, error = self._reload_replica(canary)
            if not ok:
                # The replica's own integrity/geometry gate refused the
                # push: it never stopped serving the old digest, and no
                # other replica was touched.
                self._phase("reload_failed", replica=canary.replica_id,
                            error=error[:300])
                return self._finish("failed", stage="canary_reload",
                                    error=error[:300], old_digest=old_digest,
                                    wall_s=time.perf_counter() - t0)
            seen = self._healthz_digest(canary)
            if seen != new_digest:
                # The swap the reload reported is not what /healthz shows:
                # identity cannot be verified, so don't roll a fleet on it.
                self._phase("digest_mismatch", replica=canary.replica_id,
                            reported=new_digest, observed=seen)
                self._rollback(canary, old_digest)
                return self._finish("failed", stage="digest_verify",
                                    old_digest=old_digest,
                                    wall_s=time.perf_counter() - t0)
            if new_digest == old_digest:
                # Same content re-pushed: nothing to shadow or roll.
                self._phase("no_op", replica=canary.replica_id,
                            digest=new_digest)
                return self._finish("converged", stage="no_op",
                                    old_digest=old_digest,
                                    new_digest=new_digest, rolled=0,
                                    wall_s=time.perf_counter() - t0)
            reference_pool = [r for r in self.membership.dispatchable()
                              if r.digest == old_digest]
            shadow = {"n": 0, "errors": 0, "agree": None}
            if reference_pool:
                reference = min(reference_pool, key=lambda r: r.load)
                shadow = self._shadow(canary, reference)
                self._phase("shadow_done", replica=canary.replica_id,
                            reference=reference.replica_id, **shadow)
            else:
                # Single-replica fleet: nothing to compare against.
                self._phase("shadow_skipped", replica=canary.replica_id,
                            reason="no_old_digest_reference")
            failed_gate = shadow["errors"] > 0 or (
                shadow["n"] > 0 and shadow["agree"] is not None
                and shadow["agree"] < self.agree_floor)
            if failed_gate:
                self._phase("shadow_fail", replica=canary.replica_id,
                            **shadow)
                self._rollback(canary, old_digest)
                return self._finish("failed", stage="shadow",
                                    shadow=shadow, old_digest=old_digest,
                                    wall_s=time.perf_counter() - t0)
            # Roll the remainder, one at a time.  Each replica's reload is
            # its own zero-drop atomic swap, so it stays in rotation while
            # its incoming engine warms off to the side.
            rolled, failures = [canary.replica_id], []
            for replica in list(self.membership.replicas):
                if replica is canary or replica.digest == new_digest:
                    continue
                if replica.state not in (ms.LIVE, ms.DRAINING):
                    # Out/joining members are not pushed to: a process
                    # that is down reloads nothing.  Keeping a RELAUNCH
                    # on the new checkpoint is the service wiring's job
                    # (FleetApp's on_checkpoint_change hook rewrites the
                    # supervisor's child commands after convergence).
                    continue
                ok, digest, error = self._reload_replica(replica)
                if ok and digest == new_digest:
                    replica.digest = digest
                    rolled.append(replica.replica_id)
                    self._phase("rolled", replica=replica.replica_id,
                                digest=digest)
                else:
                    failures.append({"replica": replica.replica_id,
                                     "error": error[:300]})
                    self._phase("roll_failed", replica=replica.replica_id,
                                error=error[:300])
            canary.digest = new_digest
            status = "converged" if not failures else "partial"
            self._phase(status, new_digest=new_digest, rolled=len(rolled),
                        failures=len(failures))
            return self._finish(status, stage="roll",
                                old_digest=old_digest,
                                new_digest=new_digest, shadow=shadow,
                                rolled=rolled, failures=failures,
                                wall_s=time.perf_counter() - t0)
        finally:
            # Whatever happened, the canary leaves its parked state; the
            # health poller re-LIVEs it from its next healthy poll.
            if canary.state == ms.CANARY:
                self.membership.set_state(canary, ms.DRAINING,
                                          "canary_released")

    def _rollback(self, canary: ms.Replica, old_digest: str | None) -> None:
        """Reload the canary back to the previous checkpoint; on rollback
        failure the canary stays out of rotation (draining) rather than
        serving a rejected digest."""
        if self.previous_checkpoint is None:
            self._phase("rollback_skipped", replica=canary.replica_id,
                        reason="no_previous_checkpoint")
            return
        body = json.dumps({"checkpoint": self.previous_checkpoint}).encode()
        try:
            status, _ = canary.client.request(
                "POST", "/reload", body=body,
                headers={"Content-Type": "application/json"},
                timeout_s=self.reload_timeout_s)
        except _TRANSPORT_ERRORS as exc:
            status = -1
            logger.warning("Canary rollback transport failure: %s", exc)
        if status == 200 and self._healthz_digest(canary) == old_digest:
            self._phase("rolled_back", replica=canary.replica_id,
                        digest=old_digest)
        else:
            self._phase("rollback_failed", replica=canary.replica_id,
                        http_status=status)

    def _finish(self, status: str, **fields) -> dict:
        record = {"status": status, "checkpoint": self.checkpoint, **fields}
        if "wall_s" in record:
            record["wall_s"] = round(record["wall_s"], 3)
        self._journal.event("fleet_reload", **record)
        self._journal.metrics.inc("fleet_reloads", status=status)
        return record
