"""Data parallelism over ``torch.distributed``: one process a card, a
``("data", "model")`` mesh whose model axis is 1 (``mesh.py``), and the
process group and host-side collectives (``multihost.py``)."""
