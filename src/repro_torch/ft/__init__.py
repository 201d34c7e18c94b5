"""Fault tolerance (the port of ``repro.ft``).

* :mod:`repro_torch.ft.health` — straggler detection, heartbeats and the
  simulated hot-spare cluster; pure Python, the reference's decisions.

``ft/checkpoint.py`` and ``ft/resharding.py`` come with the distributed
and training infrastructure.
"""
