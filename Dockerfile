# syntax=docker/dockerfile:1
#
# Container image for the iscc-search-tpu API server.
#
# Two-stage build: the builder compiles the native store (libtructstore.so)
# and installs the package; the runtime stage carries only the venv. The
# default backend runs JAX on CPU — on a GPU host, base this on a CUDA
# runtime image with JAX's CUDA plugin and the same entrypoint serves from
# the card; nothing else changes.

FROM python:3.12-slim AS builder

RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /src
COPY pyproject.toml requirements.lock ./
COPY iscc_search_tpu ./iscc_search_tpu

RUN make -C iscc_search_tpu/native

RUN python -m venv /app/.venv \
    && /app/.venv/bin/pip install --no-cache-dir --upgrade pip \
    # Locked pins first (reproducible image; scripts/gen_lock.py), then the
    # package itself and the runtime extras at the locked versions.
    && /app/.venv/bin/pip install --no-cache-dir -r requirements.lock \
    && /app/.venv/bin/pip install --no-cache-dir . "jax[cpu]" click rich


FROM python:3.12-slim

WORKDIR /app
COPY --from=builder /app/.venv /app/.venv
ENV PATH="/app/.venv/bin:$PATH"

RUN mkdir -p /data
ENV ISCC_SEARCH_INDEX_URI=tpu:///data
ENV ISCC_SEARCH_HOST=0.0.0.0
ENV ISCC_SEARCH_PORT=8000

EXPOSE 8000

# Single worker: device-backed indexes hold exclusive device buffers and
# segment files (same single-writer constraint the CLI enforces). Scale with
# replicas behind a load balancer (docs/howto/deployment.md).
#
# Shutdown: the server installs a SIGTERM handler that stops accepting
# connections, drains in-flight requests, then flushes segments + manifest
# (server/httpd.py). Give docker/k8s a stop grace period that covers the
# flush — see compose.yaml stop_grace_period.
ENTRYPOINT ["iscc-search-tpu"]
CMD ["serve"]
