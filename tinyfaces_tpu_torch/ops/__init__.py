"""Numeric ops of the port: dense IoU, GT assignment, sampling."""
