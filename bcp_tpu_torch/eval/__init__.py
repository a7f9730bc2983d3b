"""Sliding-window evaluation and segmentation metrics."""
