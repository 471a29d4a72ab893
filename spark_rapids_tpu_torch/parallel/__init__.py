"""Mesh topology, the pipelined executor and the in-process executor
runtime."""
