"""Across shards, processes and nodes: the mesh scan and its shuffle
(mesh.py), the multi-process runtime (multihost.py), and the node
protocol's wire format of partial results and `aggregate` merge (wire.py,
aggregator.py)."""
