"""Batched TFHE device operations on torch tensors (int32 u32 carrier)."""
