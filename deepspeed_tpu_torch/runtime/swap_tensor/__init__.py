"""NVMe residency for the offload tiers (``swapper``)."""
