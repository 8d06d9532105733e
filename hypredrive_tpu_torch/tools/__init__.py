"""Offline tools (reference analogue: utils/mat2ijbin.c,
utils/lsseq_driver.c, SURVEY.md §2.8)."""
