"""Planes-level ops ``[B, H, W]``: the port's counterparts of
``imageenhancement_mp_tpu/ops`` for the ported slice."""
