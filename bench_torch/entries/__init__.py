"""The engine paths a cell can drive, one module each, found by the name
in the cell's file (``"entry"``)."""
