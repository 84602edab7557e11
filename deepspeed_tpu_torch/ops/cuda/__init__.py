"""Hand-written Hopper kernels, each named after the Pallas function it
replaces. Importing this package builds nothing: the kernels build at
their first launch (builder.py)."""
