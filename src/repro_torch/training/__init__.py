"""Training substrate: low-res-augmented training (paper §5.3).  The
reference's optimizer, schedules and train step are not ported yet
(ROADMAP.md, port queue: 'LLM side stack')."""
