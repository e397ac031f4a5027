"""Launch helpers of the port: the device meshes of the taskvec-sharded
round (``mesh``)."""
