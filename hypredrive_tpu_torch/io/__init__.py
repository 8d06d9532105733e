"""File I/O: IJ ASCII/binary/multipart readers and the native host helpers."""
