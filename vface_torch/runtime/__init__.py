"""Resumable progress for the video swap and the npz parameter loader."""
