"""Multi-device layer of the port: logical-axis sharding rules resolved to
DTensor placements over a DeviceMesh (``sharding``), the mesh execution
of the model (``spmd``), the explicit collectives (``collectives``) and
the GPipe schedule (``pipeline``)."""
