"""Frozen copies of the port's measuring arithmetic, each headed with the file and
commit it was copied from. Later changes to the port do not move the yardstick: only a
benchmark change edits these files."""
