"""Process-wide services of the port: fault injection, query deadlines,
the memory profiler and its operator context, and a histogram."""
