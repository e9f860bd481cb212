"""Shape canonicalization, f32 FMA emulation and the fixed-point tap tables."""
