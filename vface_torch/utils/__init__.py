"""Schedules, device selection and parameter conversion for the port."""
