"""Operations and bytes that an op needs at a shape: the yardstick of the
benchmark's roofline and utilization shares, counted from the shapes
alone, whatever implements the op."""
