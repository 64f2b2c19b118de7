"""Segmentation label taxonomy."""
