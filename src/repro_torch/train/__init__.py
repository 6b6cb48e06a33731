"""Training substrate of the port: optimizer, schedules, train step."""
