"""AdamW and learning-rate schedules."""
