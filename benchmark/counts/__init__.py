"""Operations and bytes the work needs, from its shapes alone: whatever
kernel does the work, these stay the yardstick."""
