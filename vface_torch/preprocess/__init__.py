"""Alignment, keep-masks, landmarks, face detection and the synthetic face renderer."""
