"""Keypoint-format tables (port of `viz/`); drawing waits for ROADMAP queue A item 10."""
