"""Fault tolerance (the port of ``repro.ft``).

* :mod:`repro_torch.ft.health` — straggler detection, heartbeats and the
  simulated hot-spare cluster; pure Python, the reference's decisions.
* :mod:`repro_torch.ft.checkpoint` — atomic, async checkpoints in the
  reference's on-disk layout.
* :mod:`repro_torch.ft.resharding` — re-placing a state onto a new mesh.
"""
