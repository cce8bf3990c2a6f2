"""The system under test: a ``repro_torch`` ``SummarizerPod`` built from a
configuration, with its sessions admitted.  The harness drives the two
halves of ``SummarizerPod.ingest`` (``route``, then ``ingest_routed``)
as ``ingest`` calls them, and ``reset_slots`` for the re-arm.  Nothing
here is imported before the harness has looked for the card."""
from __future__ import annotations


class Program:
    def __init__(self, cfg, specs, device):
        from repro_torch.core.api import make
        from repro_torch.core.spec import SessionSpec
        from repro_torch.kernels.pod_step import KERNEL as POD
        from repro_torch.kernels.rbf_gain import KERNEL as GAIN
        from repro_torch.serve.summarize import SummarizerPod
        from repro_torch.tree import leaves_with_keys

        from .traffic import session_ids

        pod_args = dict(cfg["pod"])
        base = SessionSpec(algo=cfg["algo"], K=int(cfg["K"]),
                           d=int(cfg["d"]), a=float(cfg["a"]), **pod_args)
        self.pod = SummarizerPod(algo=make(base, device=device),
                                 sessions=int(cfg["total_sessions"]),
                                 chunk=int(cfg["chunk_per_session"]),
                                 device=device)
        self._leaves = leaves_with_keys
        self._kernels = {"pod_step": POD, "gain_traced": GAIN}
        state = self.pod.init()
        for sid, sp in zip(session_ids(cfg), specs):
            state, _, ok = self.pod.admit(state, sid, spec=SessionSpec(
                algo=cfg["algo"], d=int(cfg["d"]), a=float(cfg["a"]),
                K=int(sp["K"]), T=int(sp["T"]), eps=float(sp["eps"]),
                lengthscale=float(sp["lengthscale"]),
                kernel_kind=sp["kernel_kind"]))
            if not bool(ok):
                raise RuntimeError(f"admission of session {sid} refused")
        self.state = state

    def route(self, sids, X):
        return self.pod.route(self.state, sids, X)

    def ingest_routed(self, routed):
        self.state, info = self.pod.ingest_routed(self.state, *routed)
        return info

    def rearm(self):
        self.state = self.pod.reset_slots(self.state, self.state.active)

    def outputs(self, keys) -> dict:
        leaves = self._leaves(self.state.algo)
        return {k: leaves[k] for k in keys}

    def sid_table(self) -> list:
        return self.state.sid.tolist()

    def resets(self):
        return self.state.resets

    def dropped(self) -> int:
        """Items dropped since admission: past a chunk, or of no session."""
        st = self.state
        return int(st.drops_overflow.sum()) + int(st.drops_unknown.sum())

    def launches(self) -> dict:
        return {k: v.launches for k, v in self._kernels.items()}
