"""Launch helpers of the port: device meshes (``mesh``)."""
