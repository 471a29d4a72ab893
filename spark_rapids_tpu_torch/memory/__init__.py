"""The spill framework: tiered buffer stores and the buffer catalog — the
port of ``spark_rapids_tpu/memory/`` for what the grace join, the
out-of-core sort and the upload cache use."""
