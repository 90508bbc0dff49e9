"""Utility layer: interval algebra, math helpers, structured logging.

Reference counterpart: ``source/dentist/util/`` (region.d, math.d, log.d).
"""
