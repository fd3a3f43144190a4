"""The train step of the port: optimizer, object providers, step builders."""
