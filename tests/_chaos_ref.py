"""The reference's ChaosRunner with its restore log made deterministic,
for the port's chaos tests to compare against.

doorman_tpu/chaos/runner.py's `_log_restores` keys the restore summaries
it has logged by `id()`. A summary freed at the next mastership flip can
hand its id to the next summary, whose restore then goes unlogged, so a
warm-takeover plan's event log could differ between two runs of one
seed (ROADMAP C). Keeping every logged summary alive here means no new
summary can take a logged one's id; what the reference logs is
otherwise unchanged."""

from doorman_tpu.chaos import ChaosRunner


class RefChaosRunner(ChaosRunner):
    def __init__(self, plan):
        super().__init__(plan)
        self._kept_restores = []

    def _log_restores(self, tick):
        super()._log_restores(tick)
        self._kept_restores.extend(
            s.last_restore for s in self.servers.values()
            if getattr(s, "last_restore", None) is not None
        )
