"""Mesh topology, the pipelined executor and the executor runtime: in one
process (``LocalCluster``) and as processes (``ProcessCluster``)."""
