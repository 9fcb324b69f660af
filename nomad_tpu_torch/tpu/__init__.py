"""Device placement solver: ``mirror`` tensorizes node state on the torch
device, ``solver`` implements the Stack seam over the port's kernels."""
