"""Distributed training of the port: the process world (``mesh``), the
collectives over it (``multihost``) and the row-sharded memory banks
(``sharding``)."""
