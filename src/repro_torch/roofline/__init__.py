"""Roofline terms of a dry-run step on the H100: the hardware constants,
the collective parser and the three-term model, and the report tables."""
