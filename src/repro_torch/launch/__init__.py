"""Launchers: production mesh, multi-pod dry-run, train/serve CLIs,
roofline analysis."""
