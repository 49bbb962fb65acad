"""Host-side data loading: the precomputed parse-map masks."""
