"""Slack gateway: batch-completion summaries and CSV delivery.

Port of the reference's SlackMessageVerticle (reference:
verticles/SlackMessageVerticle.java:54-90 — jslack ``filesUpload`` when
the message carries CSV data, ``chatPostMessage`` otherwise). Uses the
Slack Web API over aiohttp; a recording client stands in when no token is
configured (tests / dev), like the reference's tests skip on placeholder
creds (reference: SlackMessageVerticleTest).
"""
from __future__ import annotations

import logging

from .. import constants as c
from .bus import MessageBus, Reply

LOG = logging.getLogger(__name__)

SLACK = "slack"                 # bus address
SLACK_MESSAGE_TEXT = "slack-message-text"
SLACK_CHANNEL_ID = "slack-channel-id"
CSV_DATA = "csv-data"
JOB_NAME_FIELD = c.JOB_NAME


class RecordingSlackClient:
    """No-token mode: record messages for inspection instead of posting."""

    def __init__(self) -> None:
        self.messages: list[dict] = []

    async def post_message(self, channel: str, text: str) -> None:
        self.messages.append({"channel": channel, "text": text})
        LOG.info("slack (recorded) #%s: %s", channel, text[:200])

    async def upload_file(self, channel: str, text: str, filename: str,
                          content: str) -> None:
        self.messages.append({"channel": channel, "text": text,
                              "filename": filename, "content": content})
        LOG.info("slack (recorded) #%s file %s (%d bytes)", channel,
                 filename, len(content))

    async def close(self) -> None:
        pass


class HttpSlackClient:
    """Slack Web API client (chat.postMessage / files.upload)."""

    def __init__(self, token: str) -> None:
        self.token = token
        self._session = None

    async def _post(self, method: str, data: dict) -> None:
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession(
                headers={"Authorization": f"Bearer {self.token}"})
        url = f"https://slack.com/api/{method}"
        async with self._session.post(url, data=data) as resp:
            body = await resp.json(content_type=None)
            if not body.get("ok"):
                raise RuntimeError(f"slack {method}: {body.get('error')}")

    async def post_message(self, channel: str, text: str) -> None:
        await self._post("chat.postMessage",
                         {"channel": channel, "text": text})

    async def upload_file(self, channel: str, text: str, filename: str,
                          content: str) -> None:
        await self._post("files.upload", {
            "channels": channel, "initial_comment": text,
            "filename": filename, "filetype": "csv", "content": content})

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


class SlackWorker:
    """Bus consumer: post a message, or upload CSV when the payload
    carries ``csv-data`` (reference: SlackMessageVerticle.java:54-90)."""

    def __init__(self, client) -> None:
        self.client = client

    def register(self, bus: MessageBus) -> None:
        bus.consumer(SLACK, self.handle)

    async def handle(self, message: dict) -> Reply:
        channel = message[SLACK_CHANNEL_ID]
        text = message[SLACK_MESSAGE_TEXT]
        try:
            if CSV_DATA in message:
                job_name = message.get(JOB_NAME_FIELD, "job")
                await self.client.upload_file(
                    channel, text, f"{job_name}.csv", message[CSV_DATA])
            else:
                await self.client.post_message(channel, text)
        except Exception as exc:
            LOG.error("slack delivery failed: %s", exc)
            return Reply.failure(502, str(exc))
        return Reply.success()


def make_client(config):
    from .. import config as cfg

    token = config.get_str(cfg.SLACK_OAUTH_TOKEN)
    if token and "YOUR_" not in token.upper():
        return HttpSlackClient(token)
    return RecordingSlackClient()
