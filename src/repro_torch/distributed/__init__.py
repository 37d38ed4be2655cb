"""The mesh layer of the port: one process per mesh device over
``torch.distributed`` (``context``), the partition specs and local index
boxes of every train-state leaf (``sharding``) and the one module every
collective goes through (``collectives``)."""
