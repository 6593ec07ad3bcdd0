"""The host point-cloud ops (csrc/pc_ops.cpp over ctypes), built at first use."""
