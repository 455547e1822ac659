"""The data library's execution layer: the logical plan (`logical`), the
task executor (`executor`), and the channel-backed streaming reader and
exchange executors (`streaming`, `exchange`)."""
