"""Device layout of the port (``parallel/mesh.py``'s layout half); the
sharding plans, the pipeline and ring attention are ROADMAP A.14."""
