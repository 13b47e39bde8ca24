"""Each kernel's operations and bytes, a function of the shapes alone: the
work the inputs need, whatever kernel implements it."""
