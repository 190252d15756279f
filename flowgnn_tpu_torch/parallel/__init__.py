"""Sharded execution over ``torch.distributed``: the mesh (``mesh``), the
halo layout (``halo``), the sharded steps (``inference``) and the
multi-host helpers (``multihost``)."""
